"""Device time attributed to the inverse layer (the MEP step around the
slice kernels: the probe shifts, the misfit and its backward, the
adjoint's V-bar sums, Adam), a step."""


def read(r):
    spent = r.layer_s.get("inverse", 0.0)
    return 1e3 * spent / r.steps2 if spent > 0 else None
