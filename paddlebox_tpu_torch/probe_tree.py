"""``--tree DIR`` for the probes run by path (push_probe.py, copy_probe.py,
cadence_probe.py, profile_pass.py).

    python3 paddlebox_tpu_torch/<probe>.py [--tree DIR]

``--tree`` imports ``paddlebox_tpu_torch`` from DIR (default: the checkout
that holds the probe), so the port's parent commit unpacked in a
git-ignored directory is measured by the same script in the same chip
call, in turns (parent, change, change, parent).

A probe run by path has its own directory, this package's, first on
sys.path; it imports this module from there, before anything of the
package is imported. So this module imports nothing of the package.
"""

from __future__ import annotations

import argparse
import os
import sys

_PKG = os.path.dirname(os.path.abspath(__file__))


def parse_args(ap: argparse.ArgumentParser) -> argparse.Namespace:
    """Add ``--tree`` to ``ap`` and parse the command line. Takes this
    package's directory off sys.path (its modules config, data, ops, ...
    must not shadow top-level ones) and puts the tree first; ``tree`` in
    the result is its absolute path."""
    ap.add_argument("--tree", default=os.path.dirname(_PKG))
    args = ap.parse_args()
    args.tree = os.path.abspath(args.tree)
    sys.path[:] = [args.tree] + [
        p for p in sys.path if os.path.abspath(p or os.curdir) != _PKG]
    return args
