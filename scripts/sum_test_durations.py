#!/usr/bin/env python3
"""Sum the per-test times that pytest prints with ``--durations``.

    python -m pytest tests/test_torch_*.py -n 6 --durations=0 --durations-min=0 > log
    python3 scripts/sum_test_durations.py log

Prints the sums of the setup, call and teardown lines, setup + call, and
the seconds by test file, largest first.
"""

import argparse
import collections
import re

LINE = re.compile(r"\s*([\d.]+)s (setup|call|teardown)\s+(\S+)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log", help="pytest output with --durations lines")
    args = ap.parse_args()
    by_phase, by_file = collections.Counter(), collections.Counter()
    with open(args.log) as f:
        for line in f:
            m = LINE.match(line)
            if m:
                secs, phase, nodeid = float(m.group(1)), m.group(2), m.group(3)
                by_phase[phase] += secs
                by_file[nodeid.split("::")[0]] += secs
    print(", ".join(f"{p} {by_phase[p]:.1f} s" for p in ("setup", "call", "teardown"))
          + f"; setup + call {by_phase['setup'] + by_phase['call']:.1f} s")
    for name, secs in by_file.most_common():
        print(f"{secs:9.1f}  {name}")


if __name__ == "__main__":
    main()
