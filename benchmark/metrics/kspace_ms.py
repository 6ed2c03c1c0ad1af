"""Device time launched under ``slice_loop.kspace`` (kernel C, or the odd
and plain loops' ``fftshift(fft2)``), summed over the cards, a frame."""

import program_spans


def read(r):
    return program_spans.kspace_ms(program_spans.of_readings(r))
