"""Compare versions of csrc/mesh.cu on one CUDA card: closest's machine
code and both queries' times, in one process.

    python3 tools/mesh_ab.py BASE.cu OTHER.cu [MORE.cu ...] [--rounds N]

Each source is built with the port's nvcc flags into its own library
under build/mesh_ab/. Printed:
- ptxas's registers for each closest instantiation of each version;
- for each closest instantiation, how many SASS lines of each version
  differ from BASE's (cuobjdump; register numbers and constants masked,
  so a pure renaming counts as equal); the kernels are matched by their
  template arguments (element type, keep plane, split);
- closest and shadow at the mesh frame's level-0 shape and on the
  512k-triangle soup (chip_smoke.py builds both), each version's median
  of 30 events per round, the versions' order rotating between rounds;
  every result held bit for bit against the first version that ran the
  query. A version whose shadow entry takes another argument list (one
  before the split shadow kernel) is timed on closest only.
The card's name and power limit close the output.
"""

import argparse
import ctypes
import difflib
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch

import chip_smoke as cs
from fast_ray_tracer_tpu_torch import _build
from fast_ray_tracer_tpu_torch.ops import mesh

OUT = ROOT / "build" / "mesh_ab"
# closest's instantiations: (element type, keep plane, split) as the
# parent's closest_kernel<T, kKeep, kSplit> and pair_kernel<T, ClosestQ<T,
# kKeep>, kSplit> mangle them
INSTANCES = [(t, k, s) for t in "fd" for k in "01" for s in "01"
             if not (t == "d" and s == "1")]


def instance(name):
    m = (re.search(r"closest_kernelI([fd])Lb([01])ELb([01])E", name)
         or re.search(r"ClosestQI([fd])Lb([01])EEELb([01])E", name))
    return m.groups() if m else None


def build(srcs):
    """{source: library}, all nvcc processes at once; prints registers."""
    nvcc = _build._nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    libs = {src: OUT / f"v{i}_{Path(src).stem}.so"
            for i, src in enumerate(srcs)}
    procs = {src: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, src, "-o", str(so)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, so in libs.items()}
    for src, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            sys.exit(f"build of {src} failed:\n{out}")
        inst = None
        for line in out.splitlines():
            if "Compiling entry function" in line:
                inst = instance(line.split("'")[1])
            elif "registers" in line and inst:
                print(f"[ptxas] {src} closest {'/'.join(inst)}: "
                      f"{line.split(':', 1)[1].strip()}")
    return libs


def sass(so):
    """{closest instance: [instruction, ...]} with registers and constants
    masked."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    txt = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                         text=True, check=True).stdout
    out, inst = {}, None
    for line in txt.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            inst = instance(m.group(1))
            if inst:
                out[inst] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(.*?)\s*;?\s*/\*", line)
        if m and inst:
            x = re.sub(r"0x[0-9a-f]+", "X", m.group(1))
            x = re.sub(r"\bU?R\d+\b", "R", x).replace(".reuse", "")
            out[inst].append(re.sub(r"\s+", " ", x))
    return out


def load(so):
    """(library with its entries typed, the queries it can run): shadow
    only where its entry takes the current argument list."""
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    tree = [vp, vp, i64, i64, i64, vp, vp, vp, i32, vp, vp, vp, vp, i32]
    lib = ctypes.CDLL(str(so))
    queries = [("closest", 5)]
    if hasattr(lib, "frt_mesh_shadow_split_f32"):
        queries.append(("shadow", 8))
    for q, extra in queries:
        fn = getattr(lib, f"frt_mesh_{q}_f32")
        fn.argtypes = tree + [vp] * extra
        fn.restype = i32
        fn = getattr(lib, f"frt_mesh_{q}_split_f32")
        fn.argtypes = [i64, i32]
        fn.restype = i32
    return lib, [q for q, _ in queries]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("mesh_ab: no CUDA device")
    srcs = args.sources
    libs = build(srcs)
    code = {src: sass(so) for src, so in libs.items()}
    base = code[srcs[0]]
    for inst in INSTANCES:
        for src in srcs[1:]:
            a, b = base[inst], code[src][inst]
            ops = difflib.SequenceMatcher(None, a, b,
                                          autojunk=False).get_opcodes()
            lines = sum(max(i2 - i1, j2 - j1)
                        for tag, i1, i2, j1, j2 in ops if tag != "equal")
            print(f"[sass] closest {'/'.join(inst)}: {src} against "
                  f"{srcs[0]}: {len(b)} / {len(a)} instructions, {lines} "
                  "lines differ")

    device = torch.device("cuda")
    _, m, o, d, so, sd = cs.mesh_level0(device)
    sir, sorig, sdirs = cs.build_soup(device)
    g = torch.Generator(device=device).manual_seed(2)
    nt = sir.tri_p1.shape[0]
    smesh = mesh.pack(sir, torch.randperm(nt, generator=g, device=device),
                      torch.rand(nt, generator=g, device=device) < 0.7)
    cases = {"closest level 0": ("closest", m, o, d),
             "closest soup": ("closest", smesh, sorig, sdirs),
             "shadow level 0": ("shadow", m, so, sd),
             "shadow soup": ("shadow", smesh, sorig, sdirs)}
    fns = {"closest": mesh.closest_cuda, "shadow": mesh.shadow_cuda}
    loaded = {src: load(so) for src, so in libs.items()}
    want, times = {}, {}
    for r in range(args.rounds):
        k = r % len(srcs)
        for src in srcs[k:] + srcs[:k]:
            mesh._lib, queries = loaded[src]
            for name, (q, mm, oo, dd) in cases.items():
                if q not in queries:
                    continue
                got = fns[q](mm, oo, dd)
                if name not in want:
                    want[name] = got
                elif not all(torch.equal(x, y)
                             for x, y in zip(got, want[name])):
                    sys.exit(f"mesh_ab: {src} {name} differs")
                times.setdefault((name, src), []).append(
                    cs.median_ms(lambda: fns[q](mm, oo, dd), reps=30))
    mesh._lib = None
    for name in cases:
        for src in srcs:
            x = times.get((name, src))
            if x:
                print(f"[time] {name}: {src}: median "
                      f"{statistics.median(x):.4f} ms, range "
                      f"{min(x):.4f}-{max(x):.4f} ms over {len(x)} rounds "
                      "(each a median of 30 events): "
                      + " ".join(f"{v:.4f}" for v in x))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
