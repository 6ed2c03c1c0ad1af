"""The slice loop's least time over the device time attributed to the
slice-loop layer: ``roofline.slice_loop_work`` a frame, at 67 TFLOP/s
and 3.35 TB/s, times the frames of the attributed pass."""


def read(r):
    spent = r.layer_s.get("slice loop", 0.0)
    if spent <= 0:
        return None
    return 100.0 * r.slice_loop_least_s * r.frames2 / spent
