"""Host clock around the benchmark's call to ``calc.setup``, a job: the
atoms of every frame binned on the host, the probes built."""


def read(r):
    s = r.spans.get("calc_setup", [])
    return 1e3 * sum(s) / len(s) if s else None
