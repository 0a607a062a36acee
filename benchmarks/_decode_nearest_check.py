"""Evidence for DetectorConfig.decode_sampling="nearest": re-runs the full
adverse-conditions sweep (same scenes/conditions as detector_parity_sweep)
with bilinear vs nearest decode sampling and diffs the detected-id sets
per (scene, condition). Nearest (1 tap) gathers a quarter of what
bilinear (4 taps) does in the decode stage — this checks the accuracy
side of that trade on CPU."""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import detector_parity_sweep as sw
from aruco_slam_tpu.ops import detector
from dataclasses import replace


def main():
    cfg_b = detector.DetectorConfig(decode_sampling="bilinear")
    cfg_n = detector.DetectorConfig(decode_sampling="nearest")

    sc = sw.scenes()
    diffs = 0
    rows = []
    for cond_name, fn in [("clean", lambda x: x)] + sw.conditions():
        b_hits = n_hits = b_false = n_false = 0
        for name, img, arena_ids in sc:
            deg = fn(img)
            b = sw.ours_ids(deg, cfg_b)
            n = sw.ours_ids(deg, cfg_n)
            b_hits += len(b & arena_ids)
            n_hits += len(n & arena_ids)
            b_false += len(b - arena_ids)
            n_false += len(n - arena_ids)
            if b != n:
                diffs += 1
                print(f"  DIFF {cond_name}/{name}: bilinear={sorted(b)} "
                      f"nearest={sorted(n)}", flush=True)
        rows.append((cond_name, b_hits, n_hits, b_false, n_false))
        print(f"{cond_name}: bilinear {b_hits} hits/{b_false} false, "
              f"nearest {n_hits} hits/{n_false} false", flush=True)
    print(f"\nscene-condition cells with any id-set difference: {diffs}")
    tot_b = sum(r[1] for r in rows)
    tot_n = sum(r[2] for r in rows)
    print(f"total true detections: bilinear {tot_b}, nearest {tot_n}")


if __name__ == "__main__":
    main()
