"""Device time launched under ``adjoint`` (multislice_diff's backward on
autograd's device thread: the adjoint's K8 and K5 and its V-bar sums), a
step."""

import program_spans


def read(r):
    return program_spans.msp_backward_ms(program_spans.of_readings(r))
