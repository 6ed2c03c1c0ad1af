"""The plain reference that decides ``correct``.

Plain PyTorch and NumPy, written from the published description of the
method (Kirkland's projected potential and multislice, the reference
PySlice's TACAW and HAADF reductions). It imports nothing of the program
under test and takes nothing the program made: the harness hands it the
same seeded frames and the configuration's numbers, and it works out the
grid, the potential, the probes and every output again.
"""
