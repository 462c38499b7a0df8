"""Time designs of the EDF march kernels that ``csrc/edf_march.cu`` was
measured against and does not use, beside the shipped one, on the card.

    python3 scripts/march_variants_torch.py [--maps levine,berlin]
                                            [--agents 4096] [--json OUT]

Each variant is the shipped source with a few lines replaced
(``VARIANTS``):
- "global cursor": every warp takes its next 32 rays from the launch's
  one cursor, instead of from its block's group of 16 neighbouring
  chunks of 32;
- "shared slots": the bilinear gradient keeps 32 positions a ray in
  dynamic shared memory, threadIdx-strided (64 KB a block), instead of 64 in a local array a thread (rays of more
  than 32 steps are marched again from 16 checkpoints).
The package is copied to a temporary directory with the changed source,
and ``scripts/march_ab_torch.py --kernels-only`` times each checkout in a
process of its own (which builds its source there), in turns: shipped,
each variant, shipped. Prints one JSON line (also written to ``--json``)
of every run's kernel times, output sums and nvcc resource report, with
the card's name and power limit. Exits non-zero without a card or when a replacement no
longer applies to the source.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "pyracecarsimulator_tpu_torch"
SOURCE = os.path.join(PKG, "csrc", "edf_march.cu")

_SLOTS = """struct Slots {
  float2* p;
  __device__ float2& operator[](int k) const {
    return p[k * kThreads + threadIdx.x];
  }
};

struct Adjoint {"""
_SLOTS_LAUNCH = """const int smem = V == kBilinear ? kSlots * kThreads * 8 : 0;
  int w = 0, sms = 0, dev = 0;
  if (cudaFuncSetAttribute(edf_march_grad_kernel<V>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &w, edf_march_grad_kernel<V>, kThreads, smem) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  w *= sms;"""

# variant -> [(text of the shipped source, its replacement, count)]
VARIANTS = {
    "global cursor": [
        ("static_cast<unsigned long long>(blockIdx.x) * kGroup +",
         "static_cast<unsigned long long>(blockIdx.x) * kWarps +", 1),
        ("chunk = take_chunk(group, cursor);",
         "chunk = warps_in_grid() + atomicAdd(cursor, 1ULL);", 1),
    ],
    "shared slots": [
        ("constexpr int kSlots = 64;", "constexpr int kSlots = 32;", 1),
        ("struct Adjoint {", _SLOTS, 1),
        ("float2 (&pos)[kSlots]", "Slots pos", 2),
        ("float2 pos[kSlots];  // the ray's positions (local memory, "
         "L1-cached)", "extern __shared__ float2 slots[];\n  "
         "Slots pos{slots};", 1),
        ("const int w = wave(edf_march_grad_kernel<V>);", _SLOTS_LAUNCH, 1),
        ("edf_march_grad_kernel<V><<<grid_of(w, a.n), kThreads, 0, stream>>>",
         "edf_march_grad_kernel<V><<<grid_of(w, a.n), kThreads, smem, "
         "stream>>>", 1),
    ],
}


def variant_tree(tmp, name):
    """A checkout under ``tmp`` holding the package with ``name``'s
    source."""
    tree = os.path.join(tmp, name.replace(" ", "_"))
    shutil.copytree(os.path.join(ROOT, PKG), os.path.join(tree, PKG),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(tree, SOURCE)
    with open(path) as f:
        text = f.read()
    for old, new, count in VARIANTS[name]:
        if text.count(old) != count:
            raise SystemExit(f"march_variants_torch.py: {name!r}: "
                             f"{old!r} occurs {text.count(old)} times in "
                             f"{SOURCE}, not {count}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--maps", default="levine,berlin")
    ap.add_argument("--agents", type=int, default=4096)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("march_variants_torch.py: no CUDA device", file=sys.stderr)
        return 2
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        trees = {name: variant_tree(tmp, name) for name in VARIANTS}
        order = [("shipped", ROOT), *trees.items(), ("shipped", ROOT)]
        for name, tree in order:
            out = subprocess.run(
                [sys.executable, os.path.join(ROOT, "scripts",
                                              "march_ab_torch.py"),
                 "--tree", tree, "--maps", args.maps, "--agents",
                 str(args.agents), "--kernels-only"],
                capture_output=True, text=True, timeout=900)
            if out.returncode:
                print(out.stdout + out.stderr, file=sys.stderr)
                return out.returncode
            res = json.loads(out.stdout.strip().splitlines()[-1])
            runs.append({"variant": name, "maps": res["maps"],
                         "nvcc_log": res["nvcc_log"]})
            print(f"{name}: {res['maps']}", file=sys.stderr, flush=True)
    line = json.dumps({"card": res["card"], "device": res["device"],
                       "runs": runs})
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
