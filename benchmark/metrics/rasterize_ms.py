"""Device time attributed to the potential layer, a frame."""


def read(r):
    spent = r.layer_s.get("potential", 0.0)
    return 1e3 * spent / r.frames2 if spent > 0 else None
