"""Device operations (kernels, copies, memsets) in the traced window over
the frames it completed: how many operations the host dispatches a
frame."""


def read(r):
    if r.device_ops == 0 or r.frames == 0:
        return None
    return r.device_ops / r.frames
