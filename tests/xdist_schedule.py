"""How pytest-xdist's `--dist load` scheduler spreads the tier-1 suite over
its workers, replayed with the durations of a finished run.

    python -m pytest tests/ -q -m 'not slow' --collect-only -p no:cacheprovider \
        | grep '::' > collect.txt
    python tests/xdist_schedule.py collect.txt run.xml [--workers 6]

`run.xml` is the junit file of a whole run (`--junitxml`). The scheduler
(xdist's `LoadScheduling`) first hands each worker a block of consecutive
tests, len // workers // 4 of them, then refills a worker from the front of
the rest whenever its queue runs low; it never moves a test once handed
out. So the worker whose first block holds the slow pre-port tests sets
the run's end, and the block size (the test count) decides which ones
that worker gets. The script prints the replayed wall time, and each
worker's first block and its summed duration. A test without a duration
in `run.xml` counts 0.3 s.
"""

import argparse
import heapq
import xml.etree.ElementTree as ET


def durations(junit_path: str) -> dict:
    out = {}
    for case in ET.parse(junit_path).getroot().iter("testcase"):
        path = case.get("classname").replace(".", "/") + ".py::" + case.get("name")
        out[path] = float(case.get("time"))
    return out


def replay(order, dur, workers: int = 6):
    """(wall, block size, first blocks) of xdist's load scheduling over
    `order` with the durations `dur`."""
    d = [dur.get(t, 0.3) for t in order]
    pending = list(range(len(order)))
    block = max(len(order) // workers // 4, 2)
    queues = {w: pending[w * block:(w + 1) * block] for w in range(workers)}
    first = {w: list(q) for w, q in queues.items()}
    del pending[:workers * block]
    events = [(d[q[0]], w) for w, q in queues.items() if q]
    heapq.heapify(events)
    wall = 0.0
    while events:
        now, w = heapq.heappop(events)
        done = queues[w].pop(0)
        wall = max(wall, now)
        if pending:  # LoadScheduling.check_schedule
            lo = max(2, len(pending) // workers // 4)
            hi = max(2, len(pending) // workers // 2)
            q = queues[w]
            if len(q) < lo and not (d[done] >= 0.1 and len(q) >= 2):
                k = hi - len(q)
                q += pending[:k]
                del pending[:k]
        if queues[w]:
            heapq.heappush(events, (now + d[queues[w][0]], w))
    return wall, block, first


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("collect", help="test ids in collection order, one a line")
    p.add_argument("junit", help="junit xml of a finished whole run")
    p.add_argument("--workers", type=int, default=6)
    args = p.parse_args()
    order = [line.strip() for line in open(args.collect) if "::" in line]
    dur = durations(args.junit)
    wall, block, first = replay(order, dur, args.workers)
    print(f"{len(order)} tests, first blocks of {block}: replayed wall {wall:.1f} s")
    for w, idx in first.items():
        load = sum(dur.get(order[i], 0.3) for i in idx)
        print(f"  worker {w}: tests {idx[0]}-{idx[-1]}, {load:.1f} s "
              f"({order[idx[0]].split('::')[0]} .. {order[idx[-1]].split('::')[0]})")


if __name__ == "__main__":
    main()
