"""Device time attributed to the streaming layer (the fold of each probe
chunk into its bins, the block's copy, the readout), a frame."""


def read(r):
    spent = r.layer_s.get("streaming", 0.0)
    return 1e3 * spent / r.frames2 if spent > 0 else None
