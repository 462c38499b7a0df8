"""A tiny copy of the benchmark for CPU tests: the same registries in a
temporary directory, the configurations cut to 64 agents x 180 beams on
a small synthetic track (a walled square with a block in the middle and
two pillars) and the mixes to 6 steps a call, so that both sides run
eagerly on the CPU in seconds."""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def track_image(n: int = 160) -> np.ndarray:
    img = np.full((n, n), 254, np.uint8)
    img[:3, :] = img[-3:, :] = img[:, :3] = img[:, -3:] = 0
    c = n // 2
    img[c - 20:c + 20, c - 20:c + 20] = 0
    img[20:26, 30:34] = 0
    img[120:123, 110:140] = 0
    return img


def make(tmp, agents=64, beams=180, cells=160, horizon=6):
    """A bench directory under ``tmp`` (and a BENCHMARK.json beside it);
    returns (root, bench_dir)."""
    root = os.path.join(str(tmp), "root")
    bench = os.path.join(root, "benchmark")
    for sub in ("configs", "traffic", "limits", "kernels", "metrics",
                "modes"):
        shutil.copytree(os.path.join(BENCH_DIR, sub), os.path.join(bench, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    os.makedirs(os.path.join(bench, "maps"))
    img = track_image(cells)
    with open(os.path.join(bench, "maps", "tiny.pgm"), "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())
    with open(os.path.join(bench, "maps", "tiny.yaml"), "w") as f:
        f.write("image: tiny.pgm\nresolution: 0.05\norigin: [-2.0, -3.0, 0.0]\n"
                "negate: 0\noccupied_thresh: 0.65\nfree_thresh: 0.196\n")
    for name in os.listdir(os.path.join(bench, "configs")):
        path = os.path.join(bench, "configs", name)
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(map="maps/tiny.yaml", agents=agents)
        cfg["scan"]["num_beams"] = beams
        with open(path, "w") as f:
            json.dump(cfg, f)
    for name in os.listdir(os.path.join(bench, "traffic")):
        path = os.path.join(bench, "traffic", name)
        with open(path) as f:
            mix = json.load(f)
        mix["horizon"] = horizon
        with open(path, "w") as f:
            json.dump(mix, f)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root, bench
