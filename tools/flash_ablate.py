"""Ablations of the port's flash-attention forward on the card.

Each variant is ``csrc/flash_attention.cu`` with a few source edits
(``VARIANTS``), built by ``nvcc`` with the production flags into
``build/ablate/`` and loaded in the production library's place, so the
wrapper (``kernels.flash_attention``) runs it as it runs the real kernel.
Variants marked timing-only compute the wrong function (a pass or the split
left out) and show what that work costs; the others are held to the plain
version within 2e-5 first.  Every variant and the yardsticks are timed in
turns, several rounds, and each one's median over the rounds is reported,
beside each kernel's registers and spills from ``ptxas``.

Run from the root of the checkout, on a machine with the card::

    python3 tools/flash_ablate.py [--rounds 5] [--iters 20]
        [--out build/flash_ablate.json]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

FA = "flash_attention.cu"
KERNELS = ("flash_attention", "flash_attention_bwd")
# the split by cvt.rna.tf32.f32, big and small both rounded by the conversion
RNA_CVT = [("mma_tf32.cuh", (
    "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n",
    '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n'
    '  return r;\n')),
    ("mma_tf32.cuh", ("  small = __float_as_uint(x - __uint_as_float(big));",
                      "  small = tf32_rna(x - __uint_as_float(big));"))]
# name -> (source edits (file in csrc/, (old, new)), the shapes it runs,
# timing only); "production" is the checkout's source
VARIANTS = {
    # the mma.sync tile route at (192, 128)
    "mma.sync": ([(FA, ("REPRO_FLASH_CASE(192, 128, launch_wg)",
                        "REPRO_FLASH_CASE(192, 128, launch_tile)"))],
                 ("mla",), False),
    # the bound of a warp-specialised mma.sync route: the tile route with
    # its split taken off the critical path altogether
    "mma.sync, no split": ([(FA, ("REPRO_FLASH_CASE(192, 128, launch_wg)",
                                  "REPRO_FLASH_CASE(192, 128, launch_tile)")),
                            (FA, ("      split_smem(Kt, Sm, S::STAGE / 4);\n",
                                  ""))], ("mla",), True),
    "no split": ([(FA, ("    split();\n    fence_proxy_async();",
                        "    fence_proxy_async();"))], ("mla",), True),
    "S 1 pass": ([(FA, ("        if constexpr (!EXACT) {\n"
                        "          wgmma_m64n32k8(s_bs",
                        "        if constexpr (false) {\n"
                        "          wgmma_m64n32k8(s_bs"))], ("mla",), True),
    "P·V 1 pass": ([(FA, ("      if constexpr (!EXACT) wgmma_m64n128k8(pv, "
                          "pa[kk].big, vd_sml",
                          "      if constexpr (false) wgmma_m64n128k8(pv, "
                          "pa[kk].big, vd_sml")),
                    (FA, ("      wgmma_m64n128k8(pv, pa[kk].small, vd_big + "
                          "off, 1);\n", ""))], ("mla",), True),
    "Q unsplit": ([(FA, ("        frag_split<EXACT>(qv, qa[kk]);",
                         "        frag_split<true>(qv, qa[kk]);"))],
                  ("mla",), True),
    "cvt.rna": (RNA_CVT, ("mla", "d128", "bwd"), False),
    # D = 128 through the tile route (mma.sync), beside the wgmma route's
    "tile D=128": ([(FA, ("REPRO_FLASH_CASE(128, 128, launch_wg)",
                          "REPRO_FLASH_CASE(128, 128, launch_tile)"))],
                   ("d128",), False),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def build_variants(build, names) -> dict[str, Path]:
    """Every variant's library, built in parallel; raises on a failure."""
    out_dir = build.BUILD_DIR.parent / "ablate"
    procs = {}
    for i, name in enumerate(names):
        vdir = out_dir / f"v{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        for src in build.CSRC.iterdir():
            text = src.read_text()
            for fname, (old, new) in VARIANTS[name][0]:
                if fname != src.name:
                    continue
                if old not in text:
                    raise RuntimeError(f"variant {name!r}: edit not found in "
                                       f"{fname}: {old!r}")
                text = text.replace(old, new)
            (vdir / src.name).write_text(text)
        # the backward too where the variant times it
        for lib in KERNELS[:1 + ("bwd" in VARIANTS[name][1])]:
            so = vdir / f"{lib}.so"
            cmd = [build.nvcc_path(), *build.ARCH_FLAGS, *build.NVCC_FLAGS,
                   "-o", str(so), str(vdir / f"{lib}.cu")]
            procs[name, lib] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so, time.perf_counter())
    libs: dict[str, dict[str, Path]] = {}
    for (name, lib), (proc, so, t0) in procs.items():
        report, _ = proc.communicate()
        log(f"[{name}] {lib}: nvcc {time.perf_counter() - t0:.1f} s, exit "
            f"{proc.returncode}")
        for line in ptxas_summary(report):
            log(f"  {line}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{report}")
        libs.setdefault(name, {})[lib] = so
    return libs


def ptxas_summary(report: str) -> list[str]:
    """Registers and spills of each flash kernel, and every warning."""
    out, fn = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spills = m.group(1), "spill ?"
            continue
        if re.search(r"warning|error|Performance Loss", line, re.I):
            out.append(line.strip())
        if fn and "flash" in fn:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                spills = f"spill {m.group(1)}/{m.group(2)} bytes"
            m = re.search(r"Used (\d+) registers", line)
            if m:
                short = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?\d+", "", fn)[:60]
                out.append(f"{short}: {m.group(1)} registers, {spills}")
                fn = None
    return out


def use(build, sos: dict[str, Path]) -> None:
    """Load each library of ``sos`` (kernel name -> path) in the
    production one's place; the others stay the production's."""
    for name in KERNELS:
        lib = ctypes.CDLL(str(sos.get(name, build.library_path(name))))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        build._LIBS[name] = lib
        for key in [k for k in build._FUNCS if k[0] == name]:
            del build._FUNCS[key]


def event_ms(torch, fn, iters: int) -> float:
    """Median device time of one ``fn()`` call (events around each call,
    all queued behind a device sleep that covers their issue)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(int(2e8))
    for s, e in evs:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="build/flash_ablate.json")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import (build, flash_attention,
                                     flash_attention_bwd, ref)

    if not torch.cuda.is_available():
        log("no CUDA device")
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    log(f"card: {card.strip()}")
    t0 = time.perf_counter()
    build.build(KERNELS)
    for name in KERNELS:
        log(f"[production {name}]")
        for line in ptxas_summary(
                build.library_path(name).with_suffix(".log").read_text()):
            log(f"  {line}")
    libs = {"production": {n: build.library_path(n) for n in KERNELS}}
    libs.update(build_variants(build, list(VARIANTS)))
    log(f"builds {time.perf_counter() - t0:.1f} s")
    fa = flash_attention.flash_attention

    # correctness of the variants that compute the function, small and
    # at the prefill shape, f32 and bf16 (bf16: the f32 route's bits on
    # the widened inputs)
    gen = torch.Generator(device=dev).manual_seed(31)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    small = []
    for D, Dv in ((192, 128), (128, 128)):
        q, k, v = rnd(2, 197, 4, D), rnd(2, 230, 2, D), rnd(2, 230, 2, Dv)
        small.append((q, k, v))
    for name, so in libs.items():
        if name != "production" and VARIANTS[name][2]:
            continue
        use(build, so)
        worst = 0.0
        for q, k, v in small:
            for causal, kv_len, q_offset in ((True, 230, 0), (True, 150, 17),
                                             (False, 197, 0)):
                kw = dict(causal=causal, kv_len=kv_len, q_offset=q_offset)
                o, lse = fa(q, k, v, return_lse=True, **kw)
                o2 = fa(q, k, v, **kw)
                w, wl = ref.flash_attention_ref(q, k, v, causal,
                                                return_lse=True, kv_len=kv_len,
                                                q_offset=q_offset)
                worst = max(worst, rel(o, w), rel(lse, wl))
                if not torch.equal(o, o2):
                    raise AssertionError(f"{name}: o's bits move with the lse")
                qb, kb, vb = (x.bfloat16() for x in (q, k, v))
                ob, lb = fa(qb, kb, vb, return_lse=True, **kw)
                o32, l32 = fa(qb.float(), kb.float(), vb.float(),
                              return_lse=True, **kw)
                if not (torch.equal(ob, o32.bfloat16())
                        and torch.equal(lb, l32)):
                    raise AssertionError(
                        f"{name}: bf16 not the f32 bits at {tuple(q.shape)} "
                        f"{kw}: {rel(ob, o32)} {rel(lb, l32)}")
        if "flash_attention_bwd" in so:   # the backward, small
            q, k, v = small[0]
            dout = torch.randn_like(fa(q, k, v))
            o, lse = fa(q, k, v, return_lse=True)
            for g, w in zip(flash_attention_bwd.flash_attention_bwd(
                    q, k, v, o, lse, dout),
                    ref.flash_attention_bwd_ref(q, k, v, o, lse, dout)):
                worst = max(worst, rel(g, w))
        torch.cuda.synchronize()
        log(f"[{name}] small shapes: {worst:.3g} of the largest from the "
            "plain version; bf16 the f32 bits; o's bits the same with the lse")
        if worst > 2e-5:
            raise AssertionError(f"{name}: {worst} > 2e-5")

    # the timed shapes: row 6b (MLA prefill), 6c/6d (MLA training with the
    # lse, bf16 and f32), rows 6/6a (D = 128)
    P = 2048
    mla = (rnd(4, P, 16, 192), rnd(4, P + 32, 16, 192),
           rnd(4, P + 32, 16, 128))
    tr = (rnd(2, P, 16, 192), rnd(2, P, 16, 192), rnd(2, P, 16, 128))
    trb = tuple(x.bfloat16() for x in tr)
    d128 = (rnd(4, P, 40, 128), rnd(4, P + 32, 8, 128),
            rnd(4, P + 32, 8, 128))
    d128t = (rnd(2, P, 40, 128), rnd(2, P, 8, 128), rnd(2, P, 8, 128))
    # the backward at MLA's training shape, f32 and bf16, from the
    # production forward's o and lse
    fb = flash_attention_bwd.flash_attention_bwd
    use(build, libs["production"])
    dout = rnd(2, P, 16, 128)
    o, lse = fa(*tr, return_lse=True)
    ob, lb = fa(*trb, return_lse=True)
    calls = {
        "bwd": [("7a backward f32", lambda: fb(*tr, o, lse, dout)),
                ("7b backward bf16",
                 lambda: fb(*trb, ob, lb, dout.bfloat16()))],
        "mla": [("6b prefill f32", lambda: fa(*mla, kv_len=P)),
                ("6d training f32 +lse", lambda: fa(*tr, return_lse=True)),
                ("6c training bf16 +lse", lambda: fa(*trb, return_lse=True))],
        "d128": [("6 prefill f32", lambda: fa(*d128, kv_len=P)),
                 ("6a training f32 +lse",
                  lambda: fa(*d128t, return_lse=True))],
    }
    for name, so in libs.items():   # at the prefill shape, once
        if name != "production" and VARIANTS[name][2]:
            continue
        use(build, so)
        if "mla" in (VARIANTS.get(name, ([], ("mla",)))[1]):
            got = fa(*mla, kv_len=P)
            want = ref.flash_attention_ref(*mla, True, kv_len=P)
            log(f"[{name}] row 6b's shape: {rel(got, want):.3g} of the "
                "largest from the plain version")
            del got, want
    qt, kt, vt = mla[0].transpose(1, 2), *(x[:, :P].transpose(1, 2)
                                           for x in mla[1:])
    tq, tk, tv = (x.transpose(1, 2) for x in tr)
    yard = {
        "6b prefill f32": ("SDPA f32", lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        "6d training f32 +lse": (
            "efficient attention f32 +lse",
            lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                tq, tk, tv, None, compute_log_sumexp=True, is_causal=True)),
    }
    times: dict[str, dict[str, list[float]]] = {}
    order = list(libs)
    for r in range(args.rounds):
        for name in order[r % len(order):] + order[:r % len(order)]:
            use(build, libs[name])
            shapes = ("mla", "d128", "bwd") if name == "production" \
                else VARIANTS[name][1]
            for shape in shapes:
                for tag, fn in calls[shape]:
                    times.setdefault(tag, {}).setdefault(name, []).append(
                        event_ms(torch, fn, args.iters))
        for tag, (yname, fn) in yard.items():
            try:
                times[tag].setdefault(yname, []).append(
                    event_ms(torch, fn, args.iters))
            except (RuntimeError, TypeError) as exc:
                log(f"{yname} at {tag}: {exc}")
    res = {tag: {n: statistics.median(v) for n, v in d.items()}
           for tag, d in times.items()}
    for tag, d in res.items():
        log(f"{tag}: " + ", ".join(f"{n} {ms:.4f} ms" for n, ms in d.items()))

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card.strip(), "ms": res,
                               "rounds": args.rounds}, indent=1))
    log(json.dumps({"card": card.strip(), "ms": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
