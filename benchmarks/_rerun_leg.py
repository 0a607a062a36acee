"""Re-run ONE leg of benchmarks/run_all.py and merge it into results.json.

Usage: python benchmarks/_rerun_leg.py config3_batched_replay [more...]

Exists so a single stale entry can be refreshed without paying the
full-suite wall time; the merge
semantics match run_all.main.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import run_all  # noqa: E402  (sets jax config on import)

LEGS = {
    "config1_ekf_reference_arena": run_all.config1_reference_arena,
    "config2_loop_100_markers": run_all.config2_loop_100,
    "config3_batched_replay": run_all.config3_batched,
    "config3b_image_level": run_all.config_image_level,
    "config4_ba_1k_500": run_all.config4_ba,
    "config5_dist_ba_10k_5k": run_all.config5_dist_ba,
}


def main():
    names = sys.argv[1:]
    assert names and all(n in LEGS for n in names), f"pick from {list(LEGS)}"
    path = os.path.join(os.path.dirname(__file__), "results.json")
    with open(path) as f:
        results = json.load(f)
    for name in names:
        t0 = time.time()
        results[name] = LEGS[name]()
        results[name]["wall_s"] = round(time.time() - t0, 1)
        print(name, json.dumps(results[name]), flush=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
    print("wrote", path)


if __name__ == "__main__":
    main()
