"""The demos of ``examples/`` and ``scripts/verify_e2e.py`` on the port.

Each runs as ``python -m pyslice_tpu_torch.examples.<name>`` with the
arguments of its counterpart, on the card by default (``--device cuda``;
without a card it stops, it never falls back to the CPU) or on the CPU
with ``--device cpu``. Outputs go to ``--out`` or the current directory.
"""
