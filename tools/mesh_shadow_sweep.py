"""Time the mesh shadow kernel over split counts, with and without its
rank cull, on one CUDA card.

    python3 tools/mesh_shadow_sweep.py

The port's shadow_cuda takes its part count from csrc/mesh.cu
(split_parts, floor kShadowMinSplit); this script calls the kernel's
entry directly with each count instead, so the floor can be re-tuned
without a knob on the port's API. Three sets of launches, as
chip_smoke.py builds them: the mesh frame's level-0 shadow rays, the
512k-triangle soup, and the rays of each mesh.shadow call of one warm
mesh_torus frame. For each split count, every launch's result is held
bit for bit against shadow_cuda's, then its median time (20 events) is
summed over the set. "Cull off" passes minimum-rank tables that never
cull. Prints one line per set and cull setting, then the card's name and
power limit.
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import chip_smoke as cs
from fast_ray_tracer_tpu_torch.ops import mesh


def shadow_split(m, orig, dirs, split):
    """mesh.shadow_cuda with `split` parts (1 for float64), through the
    kernel's entry; counts no launch."""
    mesh._check(m, orig, dirs, "mesh shadow", shadow=True)
    lib = mesh._load()
    n = orig.shape[0]
    t = torch.empty(n, dtype=orig.dtype, device=orig.device)
    rank = torch.empty(n, dtype=torch.int32, device=orig.device)
    key = torch.empty(n, dtype=torch.int64, device=orig.device) \
        if split > 1 else None
    err = getattr(lib, "frt_mesh_shadow_" + mesh._SUFFIX[orig.dtype])(
        *mesh._rays_tree(m, orig, dirs, split), m.rank.data_ptr(),
        m.cast.data_ptr(), m.sc_rank.data_ptr(), m.group_rank.data_ptr(),
        t.data_ptr(), rank.data_ptr(),
        None if key is None else key.data_ptr(),
        torch.cuda.current_stream(orig.device).cuda_stream)
    mesh._raise_on(err, "mesh shadow")
    return rank, t


def main():
    if not torch.cuda.is_available():
        sys.exit("mesh_shadow_sweep: no CUDA device")
    device = torch.device("cuda")
    _, m, _, _, so, sd = cs.mesh_level0(device)
    sir, sorig, sdirs = cs.build_soup(device)
    g = torch.Generator(device=device).manual_seed(2)
    nt = sir.tri_p1.shape[0]
    smesh = mesh.pack(sir, torch.randperm(nt, generator=g, device=device),
                      torch.rand(nt, generator=g, device=device) < 0.7)
    sets = {"level 0": [(m, so, sd)], "soup": [(smesh, sorig, sdirs)],
            "frame": cs.frame_shadow_calls(device)}
    for label, calls in sets.items():
        want = [mesh.shadow_cuda(*c) for c in calls]
        ngroups = calls[0][0].group_min.shape[0]
        splits = sorted({min(s, ngroups) for s in
                         (1, 2, 4, 8, 12, 16, 24, 32, 48, 64, ngroups)})
        for cull in (True, False):
            res = []
            for split in splits:
                ms = 0.0
                for (mm, o, d), w in zip(calls, want):
                    if not cull:
                        mm = mm._replace(
                            sc_rank=torch.full_like(mm.sc_rank, -2**31),
                            group_rank=torch.full_like(mm.group_rank, -2**31))
                    got = shadow_split(mm, o, d, split)
                    if not all(torch.equal(a, b) for a, b in zip(got, w)):
                        raise AssertionError(f"shadow {label}, split {split}"
                                             f", cull {cull}: not bitwise "
                                             "equal to shadow_cuda")
                    ms += cs.median_ms(lambda: shadow_split(mm, o, d, split),
                                       reps=20)
                res.append(f"{split}: {ms:.3f}")
            print(f"[sweep] shadow {label} ({len(calls)} launches), rank "
                  f"cull {'on' if cull else 'off'}: ms by split "
                  + ", ".join(res), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
