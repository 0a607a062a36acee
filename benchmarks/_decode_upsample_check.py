"""Evidence for DetectorConfig.decode_upsample: re-runs the adverse-
conditions sweep with exact-bilinear decode (f=1) vs quantized-position
decode (f=2, f=4) and diffs the detected-id sets per (scene, condition).
The f-x path reads ONE gathered scalar per sample point instead of 4,
at the cost of quantizing sample positions
to the 1/f pixel grid."""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import detector_parity_sweep as sw
from aruco_slam_tpu.ops import detector


def main():
    cfgs = {
        f: detector.DetectorConfig(decode_upsample=f) for f in (1, 2, 4)
    }
    sc = sw.scenes()
    diffs = {2: 0, 4: 0}
    totals = {1: 0, 2: 0, 4: 0}
    falses = {1: 0, 2: 0, 4: 0}
    for cond_name, fn in [("clean", lambda x: x)] + sw.conditions():
        hits = {f: 0 for f in cfgs}
        for name, img, arena_ids in sc:
            deg = fn(img)
            sets = {f: sw.ours_ids(deg, c) for f, c in cfgs.items()}
            for fct in cfgs:
                hits[fct] += len(sets[fct] & arena_ids)
                totals[fct] += len(sets[fct] & arena_ids)
                falses[fct] += len(sets[fct] - arena_ids)
            for fct in (2, 4):
                if sets[fct] != sets[1]:
                    diffs[fct] += 1
                    print(f"  DIFF f={fct} {cond_name}/{name}: "
                          f"exact={sorted(sets[1])} quant={sorted(sets[fct])}",
                          flush=True)
        print(f"{cond_name}: hits f1={hits[1]} f2={hits[2]} f4={hits[4]}",
              flush=True)
    print(f"\ncells differing from exact: f2={diffs[2]} f4={diffs[4]}")
    print(f"total true: {totals}; false: {falses}")


if __name__ == "__main__":
    main()
