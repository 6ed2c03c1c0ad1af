#!/usr/bin/env python
"""Generate walkthrough.ipynb from walkthrough.py (percent format).

    python -m pyslice_tpu_torch.examples.make_notebook [--out PATH]

Writes ``walkthrough.ipynb`` in the current directory unless ``--out``
says otherwise; the committed copy beside this file is refreshed with
``--out pyslice_tpu_torch/examples/walkthrough.ipynb``.
"""

import argparse
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent


def py_to_ipynb(src: str) -> dict:
    cells = []
    for chunk in re.split(r"^# %%", src, flags=re.M):
        if not chunk.strip():
            continue
        if chunk.startswith(" [markdown]"):
            md = [re.sub(r"^# ?", "", ln) for ln in chunk.splitlines()[1:]]
            while md and not md[0].strip():
                md.pop(0)
            while md and not md[-1].strip():
                md.pop()
            cells.append({"cell_type": "markdown", "metadata": {},
                          "source": [ln + "\n" for ln in md]})
        else:
            code = chunk.splitlines()
            while code and not code[0].strip():
                code.pop(0)
            while code and not code[-1].strip():
                code.pop()
            if code:
                cells.append({"cell_type": "code", "metadata": {},
                              "execution_count": None, "outputs": [],
                              "source": [ln + "\n" for ln in code]})
    return {
        "cells": cells,
        "metadata": {
            "kernelspec": {"display_name": "Python 3", "language": "python",
                           "name": "python3"},
            "language_info": {"name": "python", "version": "3"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="walkthrough.ipynb")
    args = ap.parse_args(argv)
    nb = py_to_ipynb((HERE / "walkthrough.py").read_text())
    Path(args.out).write_text(json.dumps(nb, indent=1))
    print(f"wrote {args.out} ({len(nb['cells'])} cells)")


if __name__ == "__main__":
    main()
