"""Device time attributed to the analysis layer (TACAWData's time FFT and
reductions, HAADFData), a job."""


def read(r):
    spent = r.layer_s.get("analysis", 0.0)
    return 1e3 * spent / r.steps2 if spent > 0 else None
