"""matplotlib for the visualization helpers (``Probe.plot``,
``Potential.plot``, ``HAADFData.plot``, ``calculateADF(preview=True)``).

matplotlib is optional: it is imported when a helper draws, never when a
module of the package is imported, and its absence is an ImportError that
names the helper.
"""

from __future__ import annotations


def pyplot(what: str):
    """``matplotlib.pyplot``, or an ImportError naming ``what``."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(f"{what} draws with matplotlib, which is not "
                          "installed (pip install matplotlib)") from e
    return plt
