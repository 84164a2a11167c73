#!/usr/bin/env python3
"""Replay the tier-1 run's schedule from its JUnit XML, to see which test
files set its wall.

    python3 tools/tier1_schedule.py RUN.xml [--workers 6] [--drop FILE::TEST ...]

The tier-1 command runs ``pytest -p xdist -n 6 --dist loadfile``.  Under
``loadfile`` a test file is one unit of work.  pytest-xdist queues the
units by their number of tests, most first (files with equal counts in
collection order), hands each worker one unit, and gives a worker its
next unit whenever two or fewer of its assigned tests are left (at once,
where its first unit is that small).  So a file of one or two long
tests is handed out last and often sets the wall.

This script replays that policy with the per-test times of the XML (the
run's own times, under the run's own load; no start-up or collection
time) and prints the replayed wall, the units that end last, and the
wall with the tests named by ``--drop`` set to zero seconds, which shows
what those tests cost the wall rather than the workers.
"""

from __future__ import annotations

import argparse
import collections
import heapq
import xml.etree.ElementTree as ET


def load(path):
    """``{file: [(test, seconds), ...]}`` in the XML's order."""
    units = collections.OrderedDict()
    for tc in ET.parse(path).iter("testcase"):
        cls = tc.get("classname")
        name = cls.split(".")[1] if cls.startswith("tests.") else cls
        units.setdefault(name, []).append((tc.get("name"), float(tc.get("time"))))
    return units


def replay(units, workers=6):
    """The replayed wall and ``{file: (end, worker)}``."""
    queue = collections.deque(sorted(sorted(units), key=lambda f: -len(units[f])))
    pending = [collections.deque() for _ in range(workers)]

    def hand_out(w):
        if queue:
            f = queue.popleft()
            pending[w].extend((f, s) for _, s in units[f])

    for w in range(workers):
        hand_out(w)
    for w in range(workers):
        if len(pending[w]) <= 2:
            hand_out(w)
    events, running, ends, wall = [], [None] * workers, {}, 0.0
    for w in range(workers):
        if pending[w]:
            f, s = pending[w].popleft()
            heapq.heappush(events, (s, w))
            running[w] = f
    while events:
        t, w = heapq.heappop(events)
        wall = max(wall, t)
        ends[running[w]] = (t, w)
        if len(pending[w]) <= 2:
            hand_out(w)
        if pending[w]:
            f, s = pending[w].popleft()
            heapq.heappush(events, (t + s, w))
            running[w] = f
    return wall, ends


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("xml")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--drop", nargs="*", default=[], metavar="FILE::TEST")
    args = ap.parse_args(argv)
    units = load(args.xml)
    total = sum(s for tests in units.values() for _, s in tests)
    wall, ends = replay(units, args.workers)
    print(f"worker time {total:.1f} s over {len(units)} files; replayed wall {wall:.1f} s "
          f"(an even split: {total / args.workers:.1f} s)")
    for f, (t, w) in sorted(ends.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  ends {t:8.1f} s on worker {w}: {f} ({len(units[f])} tests, "
              f"{sum(s for _, s in units[f]):.1f} s)")
    if args.drop:
        for spec in args.drop:
            f, test = spec.split("::")
            names = [n for n, _ in units[f]]
            if test not in names:
                ap.error(f"{spec}: no such test in the XML")
            i = names.index(test)
            units[f][i] = (test, 0.0)
        print(f"without {', '.join(args.drop)}: replayed wall "
              f"{replay(units, args.workers)[0]:.1f} s")


if __name__ == "__main__":
    main()
