"""Time variants of the LayerNorm kernel's instance table on one GPU.

    python3 tools/ln_variants.py

The LayerNorm of kernels B, C, B8 and C8 (toc3d_tpu_torch/csrc/vit_block.cu
layernorm_kernel) holds a row in registers; its instance for a width fixes
the accesses a thread holds (CH) and the warps a row takes (WPR). This tool
builds csrc/vit_block.cu as it is and with other instances for the main
path's 1024 and 2736 columns, each into a library of its own, binds each in
turn under the real wrappers (ops/cuda/vit_block.layernorm /
layernorm_int8), checks it against the plain version and times it with CUDA
events at B's row counts: LN1 (30000 -> 30001 rows), LN2 with the residual
and the stored sum, the SwiGLU sub-LN in place (2730 of 2736 columns) and
the quantizing LN1 and sub-LN (int8 dynamic). The variants run in turns
(each list, then reversed) and each prints its fastest and slowest time and
its share of the call's byte bound at 3.35 TB/s. Prints the card's
nvidia-smi name and power limit first; needs a CUDA card.

Variants: "as built" (one warp a row at 1024 columns, four at 2736); "w1"
one warp a row at 2736 too (11 accesses a thread), with ptxas asked for 2
resident blocks as built, then "w1 cap 3" / "w1 no cap" asking for 3 (it
spills) or 1; "w2" / "w8" two or eight warps a row at both widths.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LAUNCH_1024 = "    if (npad <= 1024) return ln_launch<4, 8, 1>(a, s);\n"
LAUNCH_2736 = "    if (npad <= 3072) return ln_launch<3, 8, 4>(a, s);\n"
MIN_BLOCKS = "  return data <= 16 ? 4 : data <= 32 ? 3 : 2;\n"


def variants(src: str) -> dict:
    """name -> source of each variant of csrc/vit_block.cu."""
    for line in (LAUNCH_1024, LAUNCH_2736, MIN_BLOCKS):
        if line not in src:
            raise SystemExit(f"ln_variants: csrc/vit_block.cu no longer has "
                             f"{line.strip()!r}; update the variants")

    def table(a: str, b: str) -> str:
        return src.replace(LAUNCH_1024, LAUNCH_1024.replace("4, 8, 1", a)) \
                  .replace(LAUNCH_2736, LAUNCH_2736.replace("3, 8, 4", b))

    # one warp of 11 accesses a thread at 2736 columns holds 44 data
    # registers: as built, ptxas is asked for 2 resident blocks (128
    # registers); "cap 3" asks for 3 (85), "no cap" for 1 (255)
    w1 = table("4, 8, 1", "11, 8, 1")
    return {
        "as built": src,
        "w1": w1,
        "w1 cap 3": w1.replace(
            MIN_BLOCKS, "  return data <= 16 ? 4 : data <= 44 ? 3 : 2;\n"),
        "w1 no cap": w1.replace(MIN_BLOCKS, "  return 1;\n"),
        "w2": table("2, 8, 2", "6, 8, 2"),
        "w8": table("1, 8, 8", "2, 8, 8"),
    }


def build_variants(out: Path) -> dict:
    from toc3d_tpu_torch.ops.cuda import build
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "vit_block.cu").read_text()
    procs = {}
    for i, (name, text) in enumerate(variants(src).items()):
        cu = out / f"vit_block_v{i}.cu"
        cu.write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(out / f"libvit_block_v{i}.so"), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out / f"libvit_block_v{i}.so")
    libs = {}
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        cur = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = m.group(1)
            elif cur and "layernorm_kernelILi" in cur and (
                    "registers" in line or "spill stores" in line):
                print(f"  ptxas {name}: {cur[16:48]} {line.strip()[-48:]}")
        lib = ctypes.CDLL(str(so))
        sigs = {**build.SIGNATURES["vit_block"], **build.QUERIES["vit_block"]}
        for fn, argtypes in sigs.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.toc3d_error_string.argtypes = [ctypes.c_int]
        lib.toc3d_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ln_variants: no CUDA device", file=sys.stderr)
        return 2
    from toc3d_tpu_torch.ops.cuda import build
    from toc3d_tpu_torch.ops.cuda import vit_block as vb
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    libs = build_variants(build.BUILD_DIR.parent / "ln_variants")
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)

    def rows(xr, npad, n):
        x = (torch.randn(xr, npad, device=dev, generator=g) * 0.7
             + 0.1).to(bf)
        x[:, n:] = 0
        return x

    x1, r1 = rows(30000, 1024, 1024), rows(30000, 1024, 1024)
    w1 = 1 + 0.1 * torch.randn(1024, device=dev, generator=g)
    b1 = 0.1 * torch.randn(1024, device=dev, generator=g)
    xs = rows(30000, 2736, 2730)
    ws = 1 + 0.1 * torch.randn(2730, device=dev, generator=g)
    bs = 0.1 * torch.randn(2730, device=dev, generator=g)
    s1, xt = torch.empty_like(x1), xs.clone()
    # name -> (kernel call, plain version, compulsory bytes)
    cases = {
        "LN1 B bf16": (lambda: vb.layernorm(x1, w1, b1, rows=30001),
                       lambda: vb.layernorm_plain(x1, w1, b1, rows=30001),
                       30000 * 2048 + 30001 * 2048),
        "LN2 + res bf16": (lambda: vb.layernorm(x1, w1, b1, r1, sum_out=s1),
                           lambda: vb.layernorm_plain(x1, w1, b1, r1),
                           30000 * 2048 * 4),
        "sub-LN bf16 in place": (
            lambda: vb.layernorm(xt, ws, bs, n=2730, out=xt),
            lambda: vb.layernorm_plain(xs, ws, bs, n=2730),
            30000 * (5460 + 5472)),
        "LN1 B int8 dyn": (
            lambda: vb.layernorm_int8(x1, w1, b1, rows=30001),
            lambda: vb.layernorm_int8_plain(x1, w1, b1, rows=30001),
            30000 * 2048 + 30001 * 1028),
        "sub-LN int8 dyn": (
            lambda: vb.layernorm_int8(xs, ws, bs, n=2730),
            lambda: vb.layernorm_int8_plain(xs, ws, bs, n=2730),
            30000 * (5460 + 2740)),
    }

    def ctime(fn, reps=50):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    ok = True
    times = {v: {c: [] for c in cases} for v in libs}
    with torch.no_grad():
        refs = {c: plain() for c, (_, plain, _) in cases.items()}
        for v in list(libs) + list(libs)[::-1]:
            build._LIBS["vit_block"] = libs[v]
            for c, (run, _, _) in cases.items():
                xt.copy_(xs)
                out, ref = run(), refs[c]
                if isinstance(out, tuple):
                    d = (out[0].int() - ref[0].int()).abs()
                    good = d.max().item() <= 1 \
                        and d.float().mean().item() <= 1e-2
                else:
                    e = (out.float() - ref.float()).abs()
                    good = (e.max().item()
                            <= 2 ** -5 * ref.float().abs().max().item()
                            and e.mean().item()
                            <= 2 ** -6 * ref.float().abs().mean().item())
                if not good:
                    print(f"FAIL {v}: {c} against its plain version")
                    ok = False
                times[v][c].append(ctime(run))
    build._LIBS.pop("vit_block", None)
    for c, (_, _, nbytes) in cases.items():
        bound = nbytes / 3.35e12 * 1e3
        print(f"{c} (bound {bound:.5f} ms): " + "; ".join(
            f"{v} {min(t[c]):.5f} / {max(t[c]):.5f} ms "
            f"({bound / min(t[c]):.0%})" for v, t in times.items()))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
