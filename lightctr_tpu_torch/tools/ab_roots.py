"""What the port's A/B tools (``path_ab``, ``kernel_ab``) share: each root
named on the command line is a checkout of the repo (the tree under test,
or a parent unpacked with ``git archive``); for each, in the order given,
a fresh process runs the tool's child script from that checkout and
prints one JSON line, which the tool prints again; then one summary line
with each root's medians."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Callable


def run_root(tool: str, child: str, root: str, *extra: str) -> dict:
    """Run ``child`` (argv: root, *extra) in a process of its own, from
    ``root``; the last line it prints, parsed.  A root without
    ``chip_smoke.py`` is refused before any process starts."""
    root = os.path.abspath(root)
    if not os.path.isfile(os.path.join(root, "chip_smoke.py")):
        raise FileNotFoundError(f"{tool}: no chip_smoke.py in {root}")
    out = subprocess.run([sys.executable, "-c", child, root, *extra],
                         cwd=root, check=True, stdout=subprocess.PIPE,
                         text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def main(doc: str, run: Callable[[str], dict],
         summarize: Callable[[list], dict], argv=None) -> int:
    """Parse the roots, ``run`` each, print its record, then the summary:
    ``summarize(records of one root)`` for each root."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args(argv)
    by_root = {}
    for root in args.roots:
        rec = run(root)
        print(json.dumps(rec), flush=True)
        by_root.setdefault(rec["root"], []).append(rec)
    print(json.dumps({"summary": {
        root: {"runs": len(recs), **summarize(recs)}
        for root, recs in by_root.items()}}), flush=True)
    return 0
