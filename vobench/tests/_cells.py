"""Small forms of the benchmark's cells for the CPU tests: the cells of
BENCHMARK.json at a size a CPU test run holds (376x240 or 376x240-scaled
cameras, fewer blobs, short windows), their end-to-end metrics left out."""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import json  # noqa: E402,F401  (for the tests)

from vobench import run  # noqa: E402


def small_cell(name: str, lanes: int = 2) -> dict:
    """The cell `name` at a CPU test's size, a batched traffic cut to
    `lanes` lanes."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    c = run.load_cell(bench, name)
    cfg, cam = c["cfg"], c["cfg"]["camera"]
    if "K_l" in cam:                        # halve the EuRoC rig
        for K in ("K_l", "K_r"):
            cam[K] = [[v / 2 if i < 2 else v for v in row]
                      for i, row in enumerate(cam[K])]
        cam.update(width=cam["width"] // 2, height=cam["height"] // 2)
        cfg["scene"].update(blobs=3000)
        cfg["reference"].update(max_disp=48, half_win=24)
    else:
        cam.update(width=376, height=240, fx=320.0, fy=320.0, cx=188.0,
                   cy=120.0, baseline_m=0.4)
        cfg["lap"] = {"frames": 240, "step_m": 0.25}
        cfg["scene"].update(blobs=3000, local_z=[2, 30])
        cfg["reference"].update(max_disp=64)
    c["end_to_end"] = []
    t = c["traffic"]
    t["sample_pairs"] = 6
    if "chunk" in t:
        t.update(lanes=lanes, chunk=3)
    return c
