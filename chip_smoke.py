#!/usr/bin/env python3
"""Smoke run of gisnav_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # build + kernel checks only, no timing
    python3 chip_smoke.py --kernels  # build + kernel checks and times, no path
    python3 chip_smoke.py --seed-spread   # cached-mode fix over RANSAC seeds
    python3 chip_smoke.py --digest   # sha256 of kernel outputs, seeded inputs

Phases, each of which fails the run (non-zero exit, no result line):

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds every kernel from the sources in this checkout;
3. kernels: each hand-written kernel against its plain PyTorch version on the
   same inputs at the paths' shapes, with the tolerance stated below, plus
   CUDA-event times of the kernel, the plain version and the closest library
   call, the kernel's device time (``device_ms``, torch.profiler), the
   whole 3-shear rotation, and the kernel's bound on an H100;
4. path 1: the bucketed warp runner with the bundled learned_lg9 weights
   (SuperPoint + LightGlue-9) at 1088x1920 and 2048 keypoints over a seeded
   rendered scene: 8 frames over 3 rotation buckets, during which its four
   kernels must launch, then a timing window of 14 bucket-refresh frames and
   64 cached frames (``--profile`` adds a torch.profiler pass over 10 more
   cached frames for the device's busy time and idle share);
5. path 2: the cached-reference runner on a 2048x2048 map with 4096
   reference keypoints over the 8x8 tile grid: one map extraction, then 16
   frames at 2048 query keypoints (fused LightGlue, one stream at a time),
   3 more with a position prior and 4 through a derotating runner, and 4
   frames at 1792 (the module route, whose attention is the masked
   attention kernel, 36 calls of 2 launches a frame);
6. path 3: the exact-warp runner for 4 frames (pair SuperPoint, gather warp
   with zoom), then the zoom-less exact-warp frame program on a 2048x2048
   map at the query's ground sample distance for 4 frames (the 3-shear
   rotation, 3 shear launches a frame: two along the last axis, one along
   the first);
7. path 4: the default bundle, harris_lg5 (Harris detector + LightGlue-5)
   at its own width, 480x640 and 512 keypoints, on the sizing of the JAX
   package's 8-yaw cached sweep (an 800x800 map at 3x the footprint): the
   cached runner on 8 yaws (query pooled to 240x320, LightGlue one stream
   at a time at 512 x 1024), the bucketed and the exact-warp runners on 4
   (dual LightGlue at 512 / 512), exact launch counts a frame; then, printed
   and not gated, the cached runner on bench.py's 2048-px map at 3x;
8. path 5: the semi-dense runner (bundled LoFTR, 480x640, 1024 matches) on
   4 frames of path 4's scene, during which no kernel of the port launches;
9. the NMS cell-max stage on a frame-sized and a map-sized heatmap (the JAX
   package runs that kernel from its stage bench alone).

``--digest`` instead prints the sha256 of the stem's, the NMS kernels' and
the shear's outputs on seeded inputs (run a copy of this script placed
beside another source's package to hold the two bit for bit).

Every fix of every path must be valid and within 10 m of the truth (path
5: where the JAX program, run on the CPU on the same frames, localizes;
elsewhere invalid as it is), and a path whose launch counts differ from
the ones it is meant to make (path 1: that never launched one of its
kernels) fails the run. The last line is ``{"ok": true, "device":
{...}}``; the line before it the per-kernel JSON. The port's JAX
counterpart is never imported.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over HBM bandwidth and its operations over the
# peak of their type
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

H, W = 1088, 1920
MAX_KP = 2048
PATH1_KERNELS = ("stem_stage", "conv_stage", "nms_select", "fused_block")
CACHED_YAWS = [0.0, 5.0, -10.0, 15.0, 30.0, 45.0, 90.0, 180.0, -45.0, 135.0,
               -90.0, 60.0, -150.0, 20.0, -30.0, 75.0]
# the cached mode matches without a warp, so its map is requested at about
# the query's ground sample distance: 1.3x the footprint over MAP px
CACHED_COVERAGE = 1.3
# of CACHED_YAWS, the frames whose fix moved least over 12 RANSAC seeds
# (``--seed-spread``): derotating the 1088x1920 frame inside itself loses
# its corners, so beyond ~45 deg under 80 matches are left and single seeds
# put the fix 8-12 m off
PRIOR_FRAMES = (1, 4, 8)  # 5, 30 and -45 deg
DEROTATE_FRAMES = (2, 4, 7, 13)  # -10, 30, 180 and 20 deg
SHEAR_YAWS = [20.0, -33.0, 61.5, 117.0]  # none a right angle
MODULE_KP = 1792  # a budget outside the fused predicate: the module route
MAP = 2048  # side of the cached mode's map
STEM_RAGGED = (100, 132)  # even, no multiple of the kernel's 8x16 tile
CACHED_FRAMES = 64  # timing window of frames that hit the bucket cache
CONV_SHAPES = [  # (name, h, w, cin, cmid, cout or None, pool) per image
    ("stage2", 544, 960, 64, 64, 64, True),
    ("stage3", 272, 480, 64, 128, 128, True),
    ("stage4", 136, 240, 128, 128, 128, False),
    ("convPa", 136, 240, 128, 256, None, False),
    ("convDa", 136, 240, 128, 256, None, False),
]
# the harris_lg5 conv stages (path 4): the 480x640 frame's, the
# cached mode's 240x320 pooled query's and the 800 map's, each checked
# against the plain version (not timed)
HARRIS_CONV_SHAPES = [
    (f"{tag} {name}", h // d, w // d, cin, cmid, cout, pool)
    for tag, h, w in (("frame", 480, 640), ("pooled", 240, 320),
                      ("map", 800, 800))
    for name, d, cin, cmid, cout, pool in (
        ("stage2", 2, 64, 64, 64, True), ("stage3", 4, 64, 128, 128, True),
        ("stage4", 8, 128, 128, 128, False),
        ("convDa", 8, 128, 256, None, False))]
# path 4's scene: the JAX package's 8-yaw cached sweep sizing
# (tests/test_cached_rotation.py: 480x640 at f = 400 px, 500 m AGL, an 800
# px map at 3x the footprint, the camera ~22 m off the centre along its yaw)
HARRIS_YAWS = [0.0, 45.0, 90.0, 135.0, 180.0, 225.0, 270.0, 315.0]
HARRIS_SCENE = dict(seed=6, h=480, w=640, yaws=HARRIS_YAWS, map_side=800,
                    coverage=3.0, offset_m=22.2)
BENCH_MAP = 2048  # bench.py's cached-mode map side, at 3x the footprint
# path 5: the frames of path 4's scene that the JAX semi-dense runner
# localizes on the CPU (tests/test_torch_loftr.py); on frame 0 it finds 12
# matches, under min_matches, and returns an invalid fix
SEMIDENSE_FRAMES = (0, 1, 2, 3)
SEMIDENSE_VALID = (1, 2, 3)
# measured beside the contract's keys: device time (``device_ms``), the
# wrapper's host time (``host_ms``), K4's two launches apart, the library's
# device time, the whole 3-shear rotation, and K1-K4's launches on path 4
EXTRA_KEYS = ("device_ms", "host_ms", "attention_ms", "epilogue_ms",
              "library_device_ms", "rotation_ms", "rotation_device_ms",
              "path4_launches")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2, batch: int = 1) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds. With ``batch`` >
    1 the events enclose that many calls issued back to back and the time is
    per call: once the queue runs ahead of the card, that is the device's
    time, without the host's cost of issuing one call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return float(np.median(times))


def device_ms(fn, calls: int = 20) -> float:
    """Device time of one ``fn()`` in milliseconds: the durations of the
    kernels and copies it runs (torch.profiler) over ``calls`` calls back to
    back, per call. Unlike events around a batch of calls, this leaves out
    the host's cost of issuing each call, which for a kernel of a few
    microseconds is the larger part: 20 calls of the K6 wrapper between two
    events take the same 0.0325 ms a call whichever kernel they run. Every
    ``fn`` launches a kernel, so a trace that caught none is a fault of the
    meter and raises."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not total_us > 0:
        raise RuntimeError("torch.profiler caught no kernel of a call that "
                           "launches one")
    return total_us / calls / 1e3


def host_ms(fn, calls: int = 100, reps: int = 5) -> float:
    """Host time of one ``fn()`` in milliseconds: the median over ``reps``
    of ``calls`` calls issued back to back from an idle card, per call. For
    a kernel shorter than the wrapper's host cost the queue never fills, so
    this is what a call costs the host (checks, allocation, ctypes,
    launch)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t) * 1e3 / calls)
    torch.cuda.synchronize()
    return float(np.median(times))


def bound_ms(nbytes: float, bf16_ops: float = 0.0,
             f32_ops: float = 0.0) -> tuple:
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = (bf16_ops / BF16_FLOPS + f32_ops / F32_FLOPS) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py needs one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi unavailable"
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from gisnav_tpu_torch.kernels.build import build_all

    t0 = time.time()
    paths = build_all(verbose=True)
    log(f"[build] {len(paths)} libraries in {time.time() - t0:.1f} s")


def _rand(gen, shape, scale=1.0, dtype=torch.float32):
    t = torch.randn(shape, generator=gen, device="cuda") * scale
    return t.to(dtype).contiguous()


def _conv_weights(gen, cin, cout):
    w = _rand(gen, (9, cin, cout), (2.0 / (9 * cin)) ** 0.5, torch.bfloat16)
    return w, _rand(gen, (cout,), 0.05)


def _library_conv(x_nchw, w9):
    import torch.nn.functional as F

    cin, cout = w9.shape[1], w9.shape[2]
    wt = w9.reshape(3, 3, cin, cout).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    return lambda: F.conv2d(x_nchw, wt, padding=1)


def check_conv(gen, quick, results):
    from gisnav_tpu_torch.features.conv import (
        conv_stage,
        conv_stage_plain,
        stem_stage,
        stem_stage_plain,
    )

    # tolerance: bf16 outputs; the kernel and the plain version sum in
    # different orders, so a value can round to a neighbouring bf16 and the
    # difference passes through the next conv: 2 bf16 ulp relative + 0.05
    def err(a, b):
        a, b = a.float(), b.float()
        d = (a - b).abs()
        bad = d > 0.05 + 2.0 ** -7 * b.abs()
        return float(d.max()), int(bad.sum())

    img = torch.rand((H, W), generator=gen, device="cuda")
    w1a, b1a = _conv_weights(gen, 1, 64)
    w1b, b1b = _conv_weights(gen, 64, 64)
    entry = {"name": "stem_stage", "route": "cuda",
             "source": "gisnav_tpu_torch/kernels/conv.cu",
             "replaces": "gisnav_tpu/features/pallas_conv.py:515",
             "max_abs_err": 0.0}
    # the frame, a ragged even size whose edge tiles are partly outside
    # the image (conv1a's image padding and conv1b's patch padding differ),
    # and path 4's frame, pooled query and map
    small = torch.rand(STEM_RAGGED, generator=gen, device="cuda")
    harris = [torch.rand(hw, generator=gen, device="cuda")
              for hw in ((480, 640), (240, 320), (800, 800))]
    for im in (img, small, *harris):
        k_out = stem_stage(im, w1a, b1a, w1b, b1b, pool=True)
        p_out = stem_stage_plain(im, w1a, b1a, w1b, b1b, pool=True)
        e, nbad = err(k_out, p_out)
        log(f"[kernel] stem_stage {im.shape[0]}x{im.shape[1]}: "
            f"max_abs_err={e:.3g} out_of_tol={nbad}")
        if nbad or not torch.isfinite(k_out.float()).all():
            raise RuntimeError("stem_stage disagrees with its plain version")
        entry["max_abs_err"] = max(entry["max_abs_err"], e)
    # conv1a (1->64) and conv1b (64->64) both take bf16 operands, so both
    # count at the bf16 rate, whatever units the kernel runs conv1a on
    nbytes = H * W * 4 + (H // 2) * (W // 2) * 64 * 2 + 9 * 65 * 64 * 2
    entry["bound_ms"], entry["bound_by"] = bound_ms(
        nbytes, bf16_ops=2 * H * W * 9 * 64 * (1 + 64))
    if not quick:
        entry["ms"] = time_ms(lambda: stem_stage(img, w1a, b1a, w1b, b1b))
        b2b = time_ms(lambda: stem_stage(img, w1a, b1a, w1b, b1b), reps=5,
                      batch=20)
        entry["device_ms"] = device_ms(
            lambda: stem_stage(img, w1a, b1a, w1b, b1b))
        log(f"[time] stem_stage: 20 back to back, per call {b2b:.4f} ms; "
            f"device {entry['device_ms']:.4f} ms")
        entry["plain_ms"] = time_ms(
            lambda: stem_stage_plain(img, w1a, b1a, w1b, b1b), reps=3)
        x1 = img.to(torch.bfloat16)[None, None].contiguous(
            memory_format=torch.channels_last)
        x2 = k_out.new_empty((1, 64, H, W)).contiguous(
            memory_format=torch.channels_last)
        c1, c2 = _library_conv(x1, w1a), _library_conv(x2, w1b)
        entry["library_ms"] = time_ms(lambda: (c1(), c2()))
        entry["library_device_ms"] = device_ms(lambda: (c1(), c2()))
        log(f"[time] stem_stage: kernel {entry['ms']:.4f} ms, plain "
            f"{entry['plain_ms']:.4f} ms, cuDNN conv2d "
            f"{entry['library_ms']:.4f} ms (device "
            f"{entry['library_device_ms']:.4f})")
    results.append(entry)

    total = {"name": "conv_stage", "route": "cuda",
             "source": "gisnav_tpu_torch/kernels/conv.cu",
             "replaces": "gisnav_tpu/features/pallas_conv.py:240",
             "max_abs_err": 0.0, "bound_ms": 0.0, "ms": 0.0, "plain_ms": 0.0,
             "library_ms": 0.0, "device_ms": 0.0, "library_device_ms": 0.0}
    t_bytes = t_ops = 0.0
    calls, lib_calls = [], []
    for name, h, w, cin, cmid, cout, pool in CONV_SHAPES + HARRIS_CONV_SHAPES:
        timed = (name, h, w, cin, cmid, cout, pool) in CONV_SHAPES
        x = torch.rand((h, w, cin), generator=gen, device="cuda").to(
            torch.bfloat16)
        w1, b1 = _conv_weights(gen, cin, cmid)
        w2, b2 = _conv_weights(gen, cmid, cout) if cout else (None, None)
        k_out = conv_stage(x, w1, b1, w2, b2, pool=pool)
        p_out = conv_stage_plain(x, w1, b1, w2, b2, pool=pool)
        e, nbad = err(k_out, p_out)
        log(f"[kernel] conv_stage {name} {h}x{w} {cin}->{cmid}"
            f"{'->' + str(cout) if cout else ''}{' pool' if pool else ''}: "
            f"max_abs_err={e:.3g} out_of_tol={nbad}")
        if nbad or not torch.isfinite(k_out.float()).all():
            raise RuntimeError(f"conv_stage {name} disagrees")
        total["max_abs_err"] = max(total["max_abs_err"], e)
        if not timed:
            continue
        c_last = cout or cmid
        ops = 2 * h * w * 9 * cin * cmid + (2 * h * w * 9 * cmid * cout
                                            if cout else 0)
        ho, wo = (h // 2, w // 2) if pool else (h, w)
        nbytes = (h * w * cin * 2 + ho * wo * c_last * 2
                  + 9 * (cin * cmid + cmid * (cout or 0)) * 2)
        t_bytes += nbytes / HBM_BPS
        t_ops += ops / BF16_FLOPS
        total["bound_ms"] += bound_ms(nbytes, bf16_ops=ops)[0]
        if not quick:
            ms = time_ms(lambda: conv_stage(x, w1, b1, w2, b2, pool=pool))
            pms = time_ms(lambda: conv_stage_plain(x, w1, b1, w2, b2,
                                                   pool=pool), reps=3)
            xl = x.permute(2, 0, 1)[None].contiguous(
                memory_format=torch.channels_last)
            lib1 = _library_conv(xl, w1)
            if w2 is not None:
                xm = x.new_empty((1, cmid, h, w)).contiguous(
                    memory_format=torch.channels_last)
                lib2 = _library_conv(xm, w2)

                def lib(lib1=lib1, lib2=lib2):
                    return lib1(), lib2()
            else:
                lib = lib1
            lms = time_ms(lib)
            log(f"[time] conv_stage {name}: kernel {ms:.4f} ms, plain "
                f"{pms:.4f} ms, cuDNN conv2d {lms:.4f} ms")
            total["ms"] += ms
            total["plain_ms"] += pms
            total["library_ms"] += lms
            # device time of a frame's five calls, one trace for each side
            calls.append(lambda x=x, w=(w1, b1, w2, b2), pool=pool:
                         conv_stage(x, *w, pool=pool))
            lib_calls.append(lib)
    if not quick:
        total["device_ms"] = device_ms(lambda: [f() for f in calls])
        total["library_device_ms"] = device_ms(
            lambda: [f() for f in lib_calls])
        log(f"[time] conv_stage, the {len(calls)} shapes: device "
            f"{total['device_ms']:.4f} ms, cuDNN conv2d device "
            f"{total['library_device_ms']:.4f} ms")
    total["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    results.append(total)


def check_nms(gen, quick, results):
    from gisnav_tpu_torch.features.nms_kernel import (
        nms_select,
        nms_select_plain,
    )

    # tolerance: cell_max bit-exact (same max ops); positions 1e-4 px (the
    # soft-argmax exp differs by an ulp between CUDA and PyTorch). Path 1's
    # frame, then path 4's frame and pooled query (240 rows: the bottom
    # border rows zeroed first, as select_keypoints does)
    e_max = e_pos = 0.0
    for h, w in ((H, W), (480, 640), (240, 320)):
        heat = torch.rand((h, w), generator=gen, device="cuda") ** 8
        if h % 32:
            heat[h - 4:] = 0.0
        k_out = nms_select(heat, 4)
        p_out = nms_select_plain(heat, 4)
        em = float((k_out[0] - p_out[0]).abs().max())
        ep = max(float((a - b).abs().max()) for a, b in
                 zip(k_out[1:], p_out[1:]))
        log(f"[kernel] nms_select {h}x{w}: cell_max err={em:.3g} "
            f"position err={ep:.3g}")
        if em != 0.0 or ep > 1e-4:
            raise RuntimeError("nms_select disagrees with its plain version")
        e_max, e_pos = max(e_max, em), max(e_pos, ep)
    heat = torch.rand((H, W), generator=gen, device="cuda") ** 8
    entry = {"name": "nms_select", "route": "cuda",
             "source": "gisnav_tpu_torch/kernels/nms_select.cu",
             "replaces": "gisnav_tpu/features/pallas_nms.py:152",
             "max_abs_err": max(e_max, e_pos), "library_ms": None}
    entry["bound_ms"], entry["bound_by"] = bound_ms(
        H * W * 4 + 3 * (H // 4) * (W // 4) * 4, f32_ops=70 * H * W)
    if not quick:
        entry["ms"] = time_ms(lambda: nms_select(heat, 4))
        entry["device_ms"] = device_ms(lambda: nms_select(heat, 4))
        entry["host_ms"] = host_ms(lambda: nms_select(heat, 4))
        entry["plain_ms"] = time_ms(lambda: nms_select_plain(heat, 4))
        # what one library kernel takes to read the same bytes
        read_ms = device_ms(lambda: torch.amax(heat))
        log(f"[time] nms_select {H}x{W}: kernel {entry['ms']:.4f} ms, "
            f"device {entry['device_ms']:.4f} ms, host "
            f"{entry['host_ms']:.4f} ms, plain "
            f"{entry['plain_ms']:.4f} ms; torch.amax of the heatmap, device "
            f"{read_ms:.4f} ms")
    results.append(entry)


def check_cellmax(gen, quick, results):
    from gisnav_tpu_torch.features.nms_kernel import (
        nms_cellmax,
        nms_cellmax_plain,
        nms_select,
    )

    # tolerance: exact (a selection of input values) against the plain
    # version and against nms_select's cell max
    entry = {"name": "nms_cellmax", "route": "cuda",
             "source": "gisnav_tpu_torch/kernels/nms_select.cu",
             "replaces": "gisnav_tpu/features/pallas_nms.py:57",
             "max_abs_err": 0.0, "library_ms": None, "bound_ms": 0.0,
             "ms": 0.0, "device_ms": 0.0, "host_ms": 0.0, "plain_ms": 0.0,
             "bound_by": "bytes"}
    for h, w in ((H, W), (MAP, MAP)):
        heat = torch.rand((h, w), generator=gen, device="cuda") ** 8
        k_out = nms_cellmax(heat, 4)
        e_plain = float((k_out - nms_cellmax_plain(heat, 4)).abs().max())
        e_sel = float((k_out - nms_select(heat, 4)[0]).abs().max())
        log(f"[kernel] nms_cellmax {h}x{w}: err vs plain={e_plain:.3g} "
            f"vs nms_select cell_max={e_sel:.3g}")
        if e_plain != 0.0 or e_sel != 0.0:
            raise RuntimeError("nms_cellmax is not exact")
        b, by = bound_ms(h * w * 4 * (1 + 1 / 16), f32_ops=34 * h * w)
        if by != "bytes":
            raise RuntimeError("nms_cellmax bound is expected to be bytes")
        entry["bound_ms"] += b
        if not quick:
            ms = time_ms(lambda: nms_cellmax(heat, 4))
            dms = device_ms(lambda: nms_cellmax(heat, 4))
            hms = host_ms(lambda: nms_cellmax(heat, 4))
            log(f"[time] nms_cellmax {h}x{w}: kernel {ms:.4f} ms, device "
                f"{dms:.4f} ms, host {hms:.4f} ms")
            entry["ms"] += ms
            entry["device_ms"] += dms
            entry["host_ms"] += hms
            entry["plain_ms"] += time_ms(lambda: nms_cellmax_plain(heat, 4))
    results.append(entry)


def check_attention(gen, quick, results):
    import torch.nn.functional as F

    from gisnav_tpu_torch.matching.attention import (
        masked_attention,
        masked_attention_plain,
    )

    # tolerance: 1e-2 of the plain version's largest |output| (f32 output of
    # bf16 probabilities times bf16 values; the kernel keeps the reference's
    # rounding points, and sums in another order can move a probability by
    # one bf16 ulp). Unit-normal q over some thousand keys gives outputs of
    # ~0.04, so each shape is also held with q x 4: sharp rows, outputs ~1
    heads, d = 4, 64
    entry = {"name": "masked_attention", "route": "cuda",
             "source": "gisnav_tpu_torch/kernels/attention.cu",
             "replaces": "gisnav_tpu/matching/pallas_attention.py:38",
             "max_abs_err": 0.0}
    ms, plain, lib, bounds, dev, lib_dev = [], [], [], [], [], []
    # the module route's four launches a layer: both self and both cross
    n0, n1 = MODULE_KP, 2 * MODULE_KP
    for kq, kk in ((n0, n0), (n1, n1), (n0, n1), (n1, n0)):
        q, k, v = (_rand(gen, (n, heads, d)) for n in (kq, kk, kk))
        mask = torch.rand((kk,), generator=gen, device="cuda") > 1 / 3
        for sharp in (1.0, 4.0):
            k_out = masked_attention(q * sharp, k, v, mask)
            p_out = masked_attention_plain(q * sharp, k, v, mask)
            e = float((k_out - p_out).abs().max())
            tol = 1e-2 * float(p_out.abs().max())
            log(f"[kernel] masked_attention Kq={kq} Kk={kk} H={heads} D={d} "
                f"q x {sharp:g}: max_abs_err={e:.3g} (tolerance {tol:.3g}, "
                f"mean |out| {float(p_out.abs().mean()):.3g})")
            if not (e <= tol) or not torch.isfinite(k_out).all():
                raise RuntimeError("masked_attention disagrees")
            entry["max_abs_err"] = max(entry["max_abs_err"], e)
        nbytes = (kq + 2 * kk) * heads * d * 2 + kk * 4 + kq * heads * d * 4
        bounds.append(bound_ms(nbytes, bf16_ops=4 * kq * kk * heads * d))
        if not quick:
            # timed on bf16 inputs, as the SDPA yardstick gets them: the
            # wrapper's casts for an f32 caller are PyTorch launches of
            # their own. One call is the wrapper's bias launch and the
            # kernel's two (statistics, then P.V)
            qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
            ms.append(time_ms(lambda: masked_attention(qb, kb, vb, mask)))
            plain.append(time_ms(
                lambda: masked_attention_plain(qb, kb, vb, mask), reps=3))
            qh, kh, vh = (t.transpose(0, 1)[None] for t in (qb, kb, vb))
            bias = torch.where(mask, 0.0, -1e9).to(torch.bfloat16)[
                None, None, None, :]

            def sdpa(qh=qh, kh=kh, vh=vh, bias=bias):
                return F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=bias)

            lib.append(time_ms(sdpa))
            dev.append(lambda qb=qb, kb=kb, vb=vb, mask=mask:
                       masked_attention(qb, kb, vb, mask))
            lib_dev.append(sdpa)
            log(f"[time] masked_attention Kq={kq} Kk={kk}: kernel "
                f"{ms[-1]:.4f} ms, plain {plain[-1]:.4f} ms, SDPA "
                f"{lib[-1]:.4f} ms")
    entry["bound_ms"] = float(np.mean([b for b, _ in bounds]))
    entry["bound_by"] = bounds[0][1]
    if not quick:
        entry["ms"], entry["plain_ms"], entry["library_ms"] = (
            float(np.mean(x)) for x in (ms, plain, lib))
        # device time of the four shapes, one trace each side, per call
        entry["device_ms"], entry["library_device_ms"] = (
            device_ms(lambda fns=fns: [f() for f in fns]) / len(fns)
            for fns in (dev, lib_dev))
        log(f"[time] masked_attention, mean of the 4 shapes: device "
            f"{entry['device_ms']:.4f} ms, SDPA device "
            f"{entry['library_device_ms']:.4f} ms")
    results.append(entry)


def check_shear(gen, quick, results, ab=False):
    """K6's two entries at path 3's shapes, then the whole 3-shear rotation.
    ``ab``: a copy of this script placed beside an older package (to time two
    sources in one call) may find no first-axis entry there."""
    import torch.nn.functional as F

    from gisnav_tpu_torch.raster import shear_kernel
    from gisnav_tpu_torch.raster.shear import rotate_and_crop_center_shear

    last = shear_kernel.shear_last_axis
    axes = [("shear_last_axis", last, shear_kernel.shear_last_axis_plain)]
    if hasattr(shear_kernel, "shear_first_axis"):
        axes.append(("shear_first_axis", shear_kernel.shear_first_axis,
                     shear_kernel.shear_first_axis_plain))
    elif not ab:
        raise RuntimeError("the package has no shear_first_axis")
    c, n = 2, MAP
    img = torch.rand((c, n, n), generator=gen, device="cuda")
    rows = torch.arange(n, dtype=torch.float32, device="cuda")
    # tolerance: 0. Both entries evaluate the plain versions' f32 expression
    # with round-to-nearest intrinsics; the first axis is also held against
    # the transpose route it replaces
    for name, kernel, plain in axes:
        entry = {"name": name, "route": "cuda",
                 "source": "gisnav_tpu_torch/kernels/shear.cu",
                 "replaces": "gisnav_tpu/raster/pallas_shear.py:30",
                 "max_abs_err": 0.0}
        entry["bound_ms"], entry["bound_by"] = bound_ms(
            2 * c * n * n * 4, f32_ops=7 * c * n * n)
        times = {k: [] for k in ("ms", "device_ms", "host_ms", "plain_ms",
                                 "library_ms", "library_device_ms")}
        for shift in (0.41, -0.41, 0.70, -0.70):
            k_out = kernel(img, shift, n / 2)
            e = float((k_out - plain(img, shift, n / 2)).abs().max())
            msg = f"max_abs_err={e:.3g}"
            if kernel is not last:
                route = last(img.transpose(-1, -2).contiguous(), shift,
                             n / 2).transpose(-1, -2)
                e_route = float((k_out - route).abs().max())
                msg += f", vs the transpose route {e_route:.3g}"
                e = max(e, e_route)
            log(f"[kernel] {name} {c}x{n}x{n} shift={shift:+.2f}: {msg}")
            if e != 0.0 or not torch.isfinite(k_out).all():
                raise RuntimeError(f"{name} disagrees")
            if quick:
                continue
            # the same resample through F.grid_sample: x then y coordinates
            moving = rows[None, :] + shift * (rows[:, None] - n / 2)
            still = rows[:, None].expand(n, n)
            gx, gy = ((moving, still) if kernel is last
                      else (still.T, moving.T))
            grid = torch.stack([2 * gx / (n - 1) - 1, 2 * gy / (n - 1) - 1],
                               dim=-1)[None]
            for prefix, fn in (
                    ("", lambda: kernel(img, shift, n / 2)),
                    ("plain_", lambda: plain(img, shift, n / 2)),
                    ("library_", lambda: F.grid_sample(
                        img[None], grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True))):
                times[prefix + "ms"].append(time_ms(
                    fn, reps=3 if prefix == "plain_" else 10))
                if prefix != "plain_":
                    times[prefix + "device_ms"].append(device_ms(fn))
            times["host_ms"].append(host_ms(lambda: kernel(img, shift,
                                                           n / 2)))
        if not quick:
            entry.update({k: float(np.mean(v)) for k, v in times.items()})
            log("[time] {} {}x{}x{}, mean of 4 shifts: {}".format(
                name, c, n, n, ", ".join(f"{k} {entry[k]:.4f}"
                                         for k in times)))
        results.append(entry)
    if quick:
        return
    # the whole zoom-less rotation (3 shears, crop) at path 3's shapes
    stack = torch.rand((n, n, c), generator=gen, device="cuda")
    rot = [(time_ms(lambda: rotate_and_crop_center_shear(stack, yaw, (H, W))),
            device_ms(lambda: rotate_and_crop_center_shear(
                stack, yaw, (H, W))))
           for yaw in SHEAR_YAWS]
    entry = results[-len(axes)]
    entry["rotation_ms"], entry["rotation_device_ms"] = (
        float(np.mean(x)) for x in zip(*rot))
    log(f"[time] shear rotation {n}x{n}x{c} -> {H}x{W}, mean of "
        f"{len(SHEAR_YAWS)} yaws: {entry['rotation_ms']:.4f} ms, device "
        f"{entry['rotation_device_ms']:.4f} ms")


def _block_inputs(gen, n, kk_total, sets):
    dim = 256
    x = _rand(gen, (n, dim))
    q = _rand(gen, (n, dim), 1.0, torch.bfloat16)
    k = _rand(gen, (kk_total, dim), 1.0, torch.bfloat16)
    v = _rand(gen, (kk_total, dim), 1.0, torch.bfloat16)
    kk = kk_total // sets
    bias = torch.where(torch.rand((sets, kk), generator=gen, device="cuda")
                       < 0.9, 0.0, -1e9).float().contiguous()
    w = [_rand(gen, (dim, dim), dim ** -0.5, torch.bfloat16),
         _rand(gen, (dim,), 0.05),
         _rand(gen, (dim, 2 * dim), (2 * dim) ** -0.5, torch.bfloat16),
         _rand(gen, (dim, 2 * dim), (2 * dim) ** -0.5, torch.bfloat16),
         _rand(gen, (2 * dim,), 0.05),
         1.0 + _rand(gen, (2 * dim,), 0.1), _rand(gen, (2 * dim,), 0.1),
         _rand(gen, (2 * dim, dim), (2 * dim) ** -0.5, torch.bfloat16),
         _rand(gen, (dim,), 0.05)]
    return x, q, k, v, bias, w


def _library_block(x, q, k, v, bias, w, heads=4):
    """SDPA + F.linear epilogue on the same inputs (one set)."""
    import torch.nn.functional as F

    n, dim = x.shape
    dh = dim // heads
    wt = [t.T.contiguous() if t.dim() == 2 else t for t in w]
    qh = q.reshape(1, n, heads, dh).transpose(1, 2)
    kh = k.reshape(1, -1, heads, dh).transpose(1, 2)
    vh = v.reshape(1, -1, heads, dh).transpose(1, 2)
    mask = bias[0].to(torch.bfloat16)[None, None, None, :]

    def run():
        m = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        m = m.transpose(1, 2).reshape(n, dim)
        m2 = F.linear(m, wt[0], w[1].to(torch.bfloat16))
        y = F.linear(torch.cat([x.to(torch.bfloat16), m2], 1),
                     torch.cat([wt[2], wt[3]], 1), w[4].to(torch.bfloat16))
        y = F.gelu(F.layer_norm(y.float(), (2 * dim,), w[5], w[6]),
                   approximate="tanh")
        return x + F.linear(y.to(torch.bfloat16), wt[7],
                            w[8].to(torch.bfloat16)).float()
    return run


def check_block(gen, quick, results):
    from gisnav_tpu_torch.matching.lightglue_fused import (
        _attention_cuda,
        _ffn_cuda,
        fused_block,
        fused_block_plain,
    )

    # tolerance: f32 outputs, the kernel mirrors every bf16 rounding point;
    # sums in another order can move a rounded value by one bf16 ulp. The
    # keys are split over a cluster and merged in split order, no atomics:
    # a second run must give the same bits
    tol = 5e-2
    entry = {"name": "fused_block", "route": "cuda",
             "source": "gisnav_tpu_torch/kernels/lightglue_block.cu",
             "replaces": "gisnav_tpu/matching/lightglue_fused.py:142, "
                         "gisnav_tpu/matching/_old_lgf.py:133",
             "max_abs_err": 0.0}
    # the one-stream cases are the cached path's four launches a layer (self
    # at 2048 and 4096, cross both ways), and the whole of what the older
    # layout's TPU kernel (_old_lgf.py) computes
    cases = [("dual self", 2 * MAX_KP, 2 * MAX_KP, 2, False),
             ("dual cross", 2 * MAX_KP, 2 * MAX_KP, 2, True),
             ("single", MAX_KP, MAX_KP, 1, False),
             ("single 2048 q x 4096 k", MAX_KP, 2 * MAX_KP, 1, False),
             ("single 4096 q x 2048 k", 2 * MAX_KP, MAX_KP, 1, False),
             ("single 4096", 2 * MAX_KP, 2 * MAX_KP, 1, False)]
    # path 4 (harris_lg5, 512 keypoints): the warp modes' dual calls and the
    # cached mode's one-stream calls at 512 query x 1024 map keypoints;
    # checked, not timed
    harris = [("harris dual self", 1024, 1024, 2, False),
              ("harris dual cross", 1024, 1024, 2, True),
              ("harris single 512", 512, 512, 1, False),
              ("harris single 512 q x 1024 k", 512, 1024, 1, False),
              ("harris single 1024 q x 512 k", 1024, 512, 1, False),
              ("harris single 1024", 1024, 1024, 1, False)]
    dual = {"ms": [], "plain_ms": [], "attention_ms": [], "epilogue_ms": [],
            "device_ms": []}
    for name, n, kk_total, sets, cross in cases + harris:
        x, q, k, v, bias, w = _block_inputs(gen, n, kk_total, sets)
        kw = dict(heads=4, sets=sets, cross=cross)
        k_out = fused_block(x, q, k, v, bias, *w, **kw)
        again = fused_block(x, q, k, v, bias, *w, **kw)
        p_out = fused_block_plain(x, q, k, v, bias, *w, **kw)
        e = float((k_out - p_out).abs().max())
        same = bool(torch.equal(k_out, again))
        log(f"[kernel] fused_block {name} ({n} rows, sets={sets}): "
            f"max_abs_err={e:.3g} second run bit-equal={same}")
        if not (e <= tol) or not torch.isfinite(k_out).all():
            raise RuntimeError(f"fused_block {name} disagrees")
        if not same:
            raise RuntimeError(f"fused_block {name}: two runs differ")
        entry["max_abs_err"] = max(entry["max_abs_err"], e)
        if quick or name.startswith("harris"):
            continue
        # the wrapper's two launches alone, on the same inputs
        msg = _attention_cuda(q, k, v, bias, 4, sets, cross)
        t = {"ms": time_ms(lambda: fused_block(x, q, k, v, bias, *w, **kw)),
             "attention_ms": time_ms(
                 lambda: _attention_cuda(q, k, v, bias, 4, sets, cross)),
             "epilogue_ms": time_ms(lambda: _ffn_cuda(x, msg, *w))}
        log(f"[time] fused_block {name}: kernel {t['ms']:.4f} ms "
            f"(attention {t['attention_ms']:.4f}, epilogue "
            f"{t['epilogue_ms']:.4f})")
        log("[time] fused_block {}: 20 back to back, per call {:.4f} ms "
            "(attention {:.4f}, epilogue {:.4f})".format(name, *(
                time_ms(f, reps=5, batch=20) for f in (
                    lambda: fused_block(x, q, k, v, bias, *w, **kw),
                    lambda: _attention_cuda(q, k, v, bias, 4, sets, cross),
                    lambda: _ffn_cuda(x, msg, *w)))))
        if sets == 2:
            t["plain_ms"] = time_ms(lambda: fused_block_plain(
                x, q, k, v, bias, *w, **kw), reps=3)
            t["device_ms"] = device_ms(lambda: fused_block(x, q, k, v, bias,
                                                           *w, **kw))
            log(f"[time] fused_block {name}: plain {t['plain_ms']:.4f} ms, "
                f"device {t['device_ms']:.4f} ms")
            for key, val in t.items():
                dual[key].append(val)
            if not cross:
                # the library does one set a call: two calls for the pair
                half = n // 2
                lib = _library_block(x[:half], q[:half], k[:half], v[:half],
                                     bias[:1], w)
                entry["library_ms"] = 2 * time_ms(lib)
                entry["library_device_ms"] = 2 * device_ms(lib)
                log(f"[time] SDPA + F.linear block, both sets: "
                    f"{entry['library_ms']:.4f} ms, device "
                    f"{entry['library_device_ms']:.4f} ms")
    n, kk, dim = 2 * MAX_KP, MAX_KP, 256
    nbytes = (n * dim * 4 * 2 + n * dim * 2 + 2 * 2 * kk * dim * 2
              + 2 * kk * 4 + 7 * dim * dim * 2)
    entry["bound_ms"], entry["bound_by"] = bound_ms(
        nbytes, bf16_ops=4 * n * kk * dim + 14 * n * dim * dim)
    if not quick:
        entry.update({key: float(np.mean(val)) for key, val in dual.items()})
    results.append(entry)


def profile_frames(run_frame, frames, n: int = 10) -> float:
    """Device time by kernel over ``n`` frames (torch.profiler);
    returns the device's busy ms per frame."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        for i in range(n):
            run_frame(frames[i % len(frames)])
        torch.cuda.synchronize()

    run()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    # device-side rows only (kernels and copies), so no time counts twice
    dev = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0]
    busy = sum(d for _, d, _ in dev) / n
    log(f"[profile] device busy {busy:.3f} ms/frame over {n} frames; "
        f"the profiled wall ({wall_ms / n:.1f} ms/frame) carries the "
        f"tracer's own cost, so the idle share is taken against the "
        f"unprofiled frame p50 of this run")
    for key, d, count in sorted(dev, key=lambda x: -x[1])[:20]:
        log(f"[profile] {d / n:9.3f} ms/frame {count // n:6d} calls/frame "
            f"{key[:90]}")
    return busy


def _frame(runner, scene, i: int, tag: str = "", **kw):
    """One frame of ``scene`` through ``runner``, logged under ``tag`` if
    given: (pose, ms on the host clock around the synchronised frame,
    horizontal error in m, f64 fix)."""
    from gisnav_tpu_torch.geometry.crs import haversine_m
    from gisnav_tpu_torch.pipeline.geopose import geopose_to_wgs84_f64

    yaw, (lon, lat) = scene.yaws[i], scene.truth_lonlat[i]
    t = time.perf_counter()
    pose = runner(scene.frames[i], scene.ortho, scene.dem, yaw, scene.k,
                  scene.crs_affine, map_stamp=1, altitude_agl=scene.alt_m,
                  **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    fix = geopose_to_wgs84_f64(pose, scene.crs_affine)
    err = haversine_m(lat, lon, fix["lat"], fix["lon"])
    if tag:
        log(f"{tag} yaw {yaw:6.1f}: {ms:8.2f} ms valid={bool(pose.valid)} "
            f"matches={int(pose.num_matches)} "
            f"inliers={int(pose.num_inliers)} error={err:.3f} m")
    return pose, ms, err, fix


def fly(runner, scene, i: int, tag: str = "", **kw):
    """One frame of ``scene`` through ``runner``: (ms on the host clock
    around a synchronised frame, error in metres); raises unless the fix is
    valid, finite and within 10 m of the truth."""
    pose, ms, err, fix = _frame(runner, scene, i, tag, **kw)
    if not (bool(pose.valid) and err < 10.0
            and np.isfinite(fix["alt_ellipsoid"])):
        raise RuntimeError(f"{tag or f'frame {i}'} (yaw {scene.yaws[i]}): "
                           f"fix invalid or {err:.2f} m off")
    return ms, err


def expect_launches(path: str, launches: dict, expected: dict) -> None:
    """Fail unless ``launches`` holds exactly ``expected`` for its keys and
    nothing for every other kernel."""
    want = {k: expected.get(k, 0) for k in launches}
    if launches != want:
        raise RuntimeError(f"{path}: launches {launches}, expected {want}")


def phase_cached_path(params, config, profile_run: bool = False) -> dict:
    """Path 2: the cached-reference runner on a MAP x MAP orthoimage."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.runners import make_cached_deep_runner
    from gisnav_tpu_torch.utils.world import render_scene

    t0 = time.time()
    scene = render_scene(seed=1, h=H, w=W, yaws=CACHED_YAWS, map_side=MAP,
                         coverage=CACHED_COVERAGE)
    log(f"[cached] scene {scene.ortho.shape} in {time.time() - t0:.1f} s")
    out = {}
    for name, kp, frames in (("fused", MAX_KP, len(CACHED_YAWS)),
                             ("module", MODULE_KP, 4)):
        cfg = dataclasses.replace(config, max_keypoints=kp)
        runner = make_cached_deep_runner(params, cfg)
        # the first frame extracts the map; run it twice untimed (kernel
        # loading, allocator), then time one extraction on a new map stamp
        fly(runner, scene, 0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        runner(scene.frames[0], scene.ortho, scene.dem, scene.yaws[0],
               scene.k, scene.crs_affine, map_stamp=2,
               altitude_agl=scene.alt_m)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t) * 1e3
        reset_launches()
        runner(scene.frames[0], scene.ortho, scene.dem, scene.yaws[0],
               scene.k, scene.crs_affine, map_stamp=1,
               altitude_agl=scene.alt_m)
        extract_launches = dict(LAUNCHES)
        reset_launches()
        rows = [fly(runner, scene, i, f"[cached {name}] frame {i}")
                for i in range(frames)]
        launches = dict(LAUNCHES)
        ms = [r[0] for r in rows]
        # the extraction frame also ran one query frame
        per_frame = {k: n // frames for k, n in launches.items()}
        extract_only = {k: extract_launches[k] - per_frame[k]
                        for k in launches}
        log(f"[cached {name}] launches over {frames} frames: {launches}; "
            f"map extraction alone: {extract_only}")
        # query SuperPoint: stem 1, stages 8, select 1; LightGlue-9: 36
        # block calls of 2 launches (fused) or 36 attention calls of 2
        # launches (row statistics, then P.V)
        block = {"fused": {"fused_block": 72 * frames},
                 "module": {"masked_attention": 72 * frames}}[name]
        expect_launches(f"cached {name}", launches,
                        {"stem_stage": frames, "conv_stage": 8 * frames,
                         "nms_select": frames, **block})
        expect_launches(f"cached {name} extraction", extract_only,
                        {"stem_stage": 1, "conv_stage": 8})
        if runner.stats != {"frames": frames + 3, "map_extractions": 3}:
            raise RuntimeError(f"cached {name}: stats {runner.stats}")
        p50 = float(np.median(ms))
        out[name] = {
            "keypoints": kp, "frames": frames, "frame_p50_ms": p50,
            "frame_p90_ms": float(np.percentile(ms, 90)),
            "map_extraction_ms": first_ms - p50,
            "max_error_m": float(max(r[1] for r in rows)),
            "mean_error_m": float(np.mean([r[1] for r in rows])),
            "launches": launches}
        if profile_run:
            busy = profile_frames(lambda i: fly(runner, scene, i),
                                  list(range(frames)))
            out[name]["device_busy_ms"] = busy
            out[name]["device_idle_share"] = 1.0 - busy / p50
        if name == "fused":
            out["options"] = cached_options(params, cfg, scene, runner)
    log("[cached] " + json.dumps(out))
    return out


def cached_options(params, cfg, scene, runner) -> dict:
    """The cached runner's two options on the card: a position prior (at the
    truth the fix stands; a degree off the map no reference keypoint is
    left, so the frame must come back invalid with no match) and query
    derotation (a runner of its own over ``DEROTATE_FRAMES``)."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.runners import make_cached_deep_runner

    errors = []
    for i in PRIOR_FRAMES:
        lon, lat = scene.truth_lonlat[i]
        errors.append(fly(runner, scene, i, f"[cached prior] frame {i}",
                          prior_lonlat=(lon, lat))[1])
        pose = runner(scene.frames[i], scene.ortho, scene.dem, scene.yaws[i],
                      scene.k, scene.crs_affine, map_stamp=1,
                      altitude_agl=scene.alt_m, prior_lonlat=(lon + 1.0, lat))
        if bool(pose.valid) or int(pose.num_matches) != 0:
            raise RuntimeError(f"cached prior: frame {i} with its prior off "
                               f"the map kept {int(pose.num_matches)} "
                               f"matches, valid={bool(pose.valid)}")
    derot = make_cached_deep_runner(params, cfg, derotate=True)
    fly(derot, scene, 0)
    reset_launches()
    rows = [fly(derot, scene, i, f"[cached derotate] frame {i}")
            for i in DEROTATE_FRAMES]
    n = len(rows)
    # the 1088x1920 camera is not square: its derotation is the gather warp
    expect_launches("cached derotate", dict(LAUNCHES),
                    {"stem_stage": n, "conv_stage": 8 * n,
                     "nms_select": n, "fused_block": 72 * n})
    return {"prior_frames": len(errors), "prior_max_error_m": max(errors),
            "derotate_frames": n,
            "derotate_max_error_m": float(max(r[1] for r in rows)),
            "derotate_frame_p50_ms": float(np.median([r[0] for r in rows]))}


def phase_exact_warp_path(params, config, scene,
                          profile_run: bool = False) -> dict:
    """Path 3: the exact-warp runner on path 1's scene, then the zoom-less
    exact-warp frame program on a map at the query's ground sample
    distance."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.geopose import (
        build_frame_to_geopose,
        build_models,
    )
    from gisnav_tpu_torch.pipeline.runners import make_deep_runner
    from gisnav_tpu_torch.utils.world import render_scene
    from gisnav_tpu_torch.weights import params_from_jax

    frames = 4
    runner = make_deep_runner(params, config)
    fly(runner, scene, 0)
    reset_launches()
    rows = [fly(runner, scene, i, f"[exact] frame {i}")
            for i in range(3, 3 + frames)]
    launches = dict(LAUNCHES)
    log(f"[exact] launches over {frames} frames: {launches}")
    # pair SuperPoint (2 x (1 + 8 + 1)), dual LightGlue (18 calls of 2)
    expect_launches("exact warp", launches,
                    {"stem_stage": 2 * frames, "conv_stage": 16 * frames,
                     "nms_select": 2 * frames, "fused_block": 36 * frames})
    ms = [r[0] for r in rows]
    out = {"runner": {"frames": frames, "frame_p50_ms": float(np.median(ms)),
                      "frame_p90_ms": float(np.percentile(ms, 90)),
                      "max_error_m": float(max(r[1] for r in rows)),
                      "launches": launches}}
    if profile_run:
        busy = profile_frames(lambda i: fly(runner, scene, i),
                              list(range(3, 3 + frames)))
        out["runner"]["device_busy_ms"] = busy
        out["runner"]["device_idle_share"] = 1.0 - busy / out["runner"][
            "frame_p50_ms"]

    t0 = time.time()
    zl = render_scene(seed=2, h=H, w=W, yaws=SHEAR_YAWS, map_side=MAP,
                      coverage=MAP / W)
    log(f"[shear] scene {zl.ortho.shape} at the query's GSD in "
        f"{time.time() - t0:.1f} s")
    dev = torch.device("cuda")
    models = build_models(params_from_jax(params, dev), config)
    program = build_frame_to_geopose(config)
    generator = torch.Generator(device=dev)
    state = {"n": 0}

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def zoomless(query, ortho, dem, rotation_deg, k, crs_affine,
                 map_stamp=None, altitude_agl=None):
        """The frame program as a runner: the map is uploaded once, no zoom
        is passed."""
        if "ortho" not in state:
            state["ortho"], state["dem"] = f32(ortho) / 255.0, f32(dem)
        state["n"] += 1
        generator.manual_seed(state["n"])
        return program(models, f32(query) / 255.0, state["ortho"],
                       state["dem"], rotation_deg, f32(k), f32(crs_affine),
                       generator=generator)

    fly(zoomless, zl, 0)
    reset_launches()
    rows = [fly(zoomless, zl, i, f"[shear] frame {i}")
            for i in range(len(SHEAR_YAWS))]
    ms, errors = [r[0] for r in rows], [r[1] for r in rows]
    launches = dict(LAUNCHES)
    frames = len(SHEAR_YAWS)
    log(f"[shear] launches over {frames} frames: {launches}")
    # the rotation's two x-shears and its y-shear
    expect_launches("zoom-less exact warp", launches,
                    {"shear_last_axis": 2 * frames,
                     "shear_first_axis": frames,
                     "stem_stage": 2 * frames, "conv_stage": 16 * frames,
                     "nms_select": 2 * frames, "fused_block": 36 * frames})
    out["zoomless"] = {"frames": frames,
                       "frame_p50_ms": float(np.median(ms)),
                       "frame_p90_ms": float(np.percentile(ms, 90)),
                       "max_error_m": float(max(errors)),
                       "launches": launches}
    log("[exact] " + json.dumps(out))
    return out


def _times(rows) -> dict:
    ms = [r[0] for r in rows]
    return {"frames": len(rows), "frame_p50_ms": float(np.median(ms)),
            "frame_p90_ms": float(np.percentile(ms, 90)),
            "max_error_m": float(max(r[1] for r in rows))}


def phase_harris_path(profile_run: bool = False) -> dict:
    """Path 4: the default bundle (``params=None``: harris_lg5 with
    PRETRAINED_CONFIG) through the three deep runners on the JAX 8-yaw
    sweep's sizing, then the cached runner on bench.py's 2048-px map."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.runners import (
        make_bucketed_warp_runner,
        make_cached_deep_runner,
        make_deep_runner,
    )
    from gisnav_tpu_torch.utils.world import render_scene

    t0 = time.time()
    scene = render_scene(**HARRIS_SCENE)
    log(f"[harris] scene {scene.ortho.shape} in {time.time() - t0:.1f} s")
    # a Harris SuperPoint pass: stem 1, stages 2-4 two convs each and
    # convDa (no detector head), select 1. LightGlue-5: 5 layers of a self
    # and a cross stage, each one dual call (warp modes: 512 / 512) or two
    # one-stream calls (cached: 512 / 1024), 2 launches a call
    sp = {"stem_stage": 1, "conv_stage": 7, "nms_select": 1}
    plans = {
        "cached": (make_cached_deep_runner, list(range(len(HARRIS_YAWS))),
                   {**sp, "fused_block": 40}),
        "bucketed": (make_bucketed_warp_runner, [0, 1, 2, 3],
                     {**sp, "fused_block": 20}),
        "exact": (make_deep_runner, [0, 1, 2, 3],
                  {k: 2 * n for k, n in sp.items()} | {"fused_block": 20}),
    }
    out = {}
    for name, (make, frames, per_frame) in plans.items():
        runner = make()
        # untimed: the cached runner extracts the map at its first frame;
        # the bucketed runner fills one bucket a yaw (4 yaws, 4 buckets of
        # 15 deg, a 4-entry cache), so the counted frames all hit
        for i in (frames if name == "bucketed" else frames[:1]):
            fly(runner, scene, i)
        reset_launches()
        rows = [fly(runner, scene, i, f"[harris {name}] frame {i}")
                for i in frames]
        launches = dict(LAUNCHES)
        n = len(frames)
        log(f"[harris {name}] launches over {n} frames: {launches}")
        expect_launches(f"harris {name}", launches,
                        {k: c * n for k, c in per_frame.items()})
        out[name] = {**_times(rows), "launches": launches}
        if name == "cached":
            # one more map extraction (a new stamp) and its frame
            reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            runner(scene.frames[0], scene.ortho, scene.dem, 0.0, scene.k,
                   scene.crs_affine, map_stamp=2, altitude_agl=scene.alt_m)
            torch.cuda.synchronize()
            out[name]["map_extraction_ms"] = (
                (time.perf_counter() - t) * 1e3 - out[name]["frame_p50_ms"])
            expect_launches("harris cached extraction", dict(LAUNCHES),
                            {"stem_stage": 2, "conv_stage": 14,
                             "nms_select": 1, "fused_block": 40})
        if profile_run:
            busy = profile_frames(lambda i: fly(runner, scene, i), frames)
            out[name]["device_busy_ms"] = busy
            out[name]["device_idle_share"] = 1.0 - busy / out[name][
                "frame_p50_ms"]
    out["bench_map"] = harris_bench_map()
    log("[harris] " + json.dumps(out))
    return out


def harris_bench_map() -> dict:
    """Printed, not gated: the cached runner with harris_lg5 on bench.py's
    2048-px cached-mode map at 3x the footprint (the map at about the 480x640
    query's ground sample distance: no pooling), all 8 yaws."""
    from gisnav_tpu_torch.pipeline.runners import make_cached_deep_runner
    from gisnav_tpu_torch.utils.world import render_scene

    t0 = time.time()
    scene = render_scene(**{**HARRIS_SCENE, "map_side": BENCH_MAP})
    log(f"[harris bench map] scene {scene.ortho.shape} in "
        f"{time.time() - t0:.1f} s")
    runner = make_cached_deep_runner()
    rows = []
    for i in range(len(HARRIS_YAWS)):
        pose, _, err, _ = _frame(runner, scene, i, "[harris bench map]")
        rows.append((bool(pose.valid), err))
    return {"map": BENCH_MAP, "frames": len(rows),
            "valid_fraction": sum(v for v, _ in rows) / len(rows),
            "under_10m": sum(v and e < 10.0 for v, e in rows),
            "errors_m": [round(float(e), 3) for _, e in rows]}


def phase_semidense_path(profile_run: bool = False) -> dict:
    """Path 5: the semi-dense runner (bundled LoFTR, plain PyTorch: no
    kernel of the port) on path 4's scene. Each frame holds the JAX
    program's behaviour on the CPU: valid and within 10 m where it
    localizes, invalid where it does not."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.runners import make_semidense_runner
    from gisnav_tpu_torch.utils.world import render_scene

    scene = render_scene(**HARRIS_SCENE)
    runner = make_semidense_runner()
    _frame(runner, scene, SEMIDENSE_FRAMES[0])
    reset_launches()
    rows = []
    for i in SEMIDENSE_FRAMES:
        pose, ms, err, _ = _frame(runner, scene, i, f"[semidense] frame {i}")
        valid = bool(pose.valid)
        if i in SEMIDENSE_VALID:
            if not (valid and err < 10.0):
                raise RuntimeError(f"semidense frame {i}: fix invalid or "
                                   f"{err:.2f} m off")
        elif valid:
            raise RuntimeError(f"semidense frame {i}: valid where the JAX "
                               f"program's fix is not")
        rows.append((ms, err))
    if any(LAUNCHES.values()):
        raise RuntimeError(f"semidense path launched {dict(LAUNCHES)}")
    out = {**_times([rows[SEMIDENSE_FRAMES.index(i)]
                     for i in SEMIDENSE_VALID]),
           "all_frames_p50_ms": float(np.median([r[0] for r in rows])),
           "launches": dict(LAUNCHES)}
    if profile_run:
        busy = profile_frames(lambda i: _frame(runner, scene, i),
                              list(SEMIDENSE_FRAMES))
        out["device_busy_ms"] = busy
        out["device_idle_share"] = 1.0 - busy / out["all_frames_p50_ms"]
    log("[semidense] " + json.dumps(out))
    return out


def phase_seed_spread(seeds: int = 12) -> None:
    """How far the cached runner's fix moves with the RANSAC seed: every
    frame of path 2's scene ``seeds`` times (the runner seeds its generator
    with its frame counter), with a prior at the truth and through a
    derotating runner. Prints a table and checks nothing."""
    from gisnav_tpu_torch.geometry.crs import haversine_m
    from gisnav_tpu_torch.pipeline.geopose import geopose_to_wgs84_f64
    from gisnav_tpu_torch.pipeline.runners import make_cached_deep_runner
    from gisnav_tpu_torch.utils.world import render_scene
    from gisnav_tpu_torch.weights import load_bundled

    params, config = load_bundled("learned_lg9")
    config = dataclasses.replace(config, image_shape=(H, W),
                                 max_keypoints=MAX_KP, lightglue_depth=9)
    scene = render_scene(seed=1, h=H, w=W, yaws=CACHED_YAWS, map_side=MAP,
                         coverage=CACHED_COVERAGE)
    for name, derotate in (("prior", False), ("derotate", True)):
        runner = make_cached_deep_runner(params, config, derotate=derotate)
        for i, (yaw, (lon, lat)) in enumerate(zip(scene.yaws,
                                                  scene.truth_lonlat)):
            poses = [runner(scene.frames[i], scene.ortho, scene.dem, yaw,
                            scene.k, scene.crs_affine, map_stamp=1,
                            altitude_agl=scene.alt_m,
                            prior_lonlat=None if derotate else (lon, lat))
                     for _ in range(seeds)]
            fixes = [geopose_to_wgs84_f64(p, scene.crs_affine) for p in poses]
            err = [haversine_m(lat, lon, f["lat"], f["lon"]) for f in fixes]
            inl = [int(p.num_inliers) for p in poses]
            log(f"[seeds {name}] frame {i} yaw {yaw:6.1f}: matches "
                f"{int(poses[0].num_matches)} inliers {min(inl)}-{max(inl)} "
                f"valid {sum(bool(p.valid) for p in poses)}/{seeds} error "
                f"min {min(err):.2f} median {float(np.median(err)):.2f} "
                f"max {max(err):.2f} m")


def phase_digest() -> None:
    """sha256 of kernel outputs on seeded inputs, to hold two sources of the
    kernels bit for bit (run this script from a copy placed beside the other
    source's package): the stem's bf16 output (pool on and off), K3's three
    outputs and K7's at the frame and map sizes, and K6's last-axis shear of
    a 2 x 2048 x 2048 stack at four shifts. Where the package has the
    first-axis shear, its digests too, and it must equal the transpose route
    on the card bit for bit."""
    from gisnav_tpu_torch.features.conv import stem_stage
    from gisnav_tpu_torch.features.nms_kernel import nms_cellmax, nms_select
    from gisnav_tpu_torch.raster import shear_kernel

    def show(what, t):
        digest = hashlib.sha256(
            t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        log(f"[digest] {what}: {digest.hexdigest()}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    img = torch.rand((H, W), generator=gen, device="cuda")
    args = (*_conv_weights(gen, 1, 64), *_conv_weights(gen, 64, 64))
    for pool in (True, False):
        show(f"stem {H}x{W} pool={pool}", stem_stage(img, *args, pool=pool))
    for h, w in ((H, W), (MAP, MAP)):
        heat = torch.rand((h, w), generator=gen, device="cuda") ** 8
        for name, t in zip(("cell_max", "cell_x", "cell_y"),
                           nms_select(heat, 4)):
            show(f"nms_select {h}x{w} {name}", t)
        show(f"nms_cellmax {h}x{w}", nms_cellmax(heat, 4))
    stack = torch.rand((2, MAP, MAP), generator=gen, device="cuda")
    first = getattr(shear_kernel, "shear_first_axis", None)
    for shift in (0.41, -0.41, 0.70, -0.999):
        show(f"shear_last_axis 2x{MAP}x{MAP} shift={shift:+.3f}",
             shear_kernel.shear_last_axis(stack, shift, MAP / 2))
        if first is None:
            continue
        out = first(stack, shift, MAP / 2)
        show(f"shear_first_axis 2x{MAP}x{MAP} shift={shift:+.3f}", out)
        route = shear_kernel.shear_last_axis(
            stack.transpose(-1, -2).contiguous(), shift, MAP / 2)
        if not torch.equal(out, route.transpose(-1, -2)):
            raise RuntimeError("shear_first_axis differs from the transpose "
                               "route")
    log("[digest] done")


def phase_cellmax_stage() -> int:
    """The NMS cell-max stage on a frame-sized and a map-sized heatmap, as
    the JAX package's stage bench runs its kernel; returns the launches."""
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.features.nms_kernel import nms_cellmax

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    reset_launches()
    for h, w in ((H, W), (MAP, MAP)):
        heat = torch.rand((h, w), generator=gen, device="cuda") ** 8
        cells = nms_cellmax(heat, 4)
        torch.cuda.synchronize()
        if cells.shape != (h // 4, w // 4) or not (
                torch.isfinite(cells).all() and float(cells.max()) > 0):
            raise RuntimeError("nms_cellmax stage gave no cell maxima")
    launches = dict(LAUNCHES)
    expect_launches("cell-max stage", launches, {"nms_cellmax": 2})
    log(f"[cellmax] launches: {launches}")
    return launches["nms_cellmax"]


def phase_main_path(profile_run: bool = False) -> dict:
    from gisnav_tpu_torch.kernels import LAUNCHES, reset_launches
    from gisnav_tpu_torch.pipeline.runners import make_bucketed_warp_runner
    from gisnav_tpu_torch.utils.world import render_scene
    from gisnav_tpu_torch.weights import load_bundled

    t0 = time.time()
    yaws = [0.0, 3.0, 6.0, 16.0, 20.0, 31.0, 35.0, 2.0]  # 3 buckets
    cycle_yaws = [45.0, 60.0, 75.0, 90.0]  # with 0, 16, 31: 7 buckets
    scene = render_scene(seed=0, h=H, w=W, yaws=yaws + cycle_yaws)
    params, config = load_bundled("learned_lg9")
    config = dataclasses.replace(config, image_shape=(H, W),
                                 max_keypoints=MAX_KP, lightglue_depth=9)
    runner = make_bucketed_warp_runner(params, config, bucket_deg=15.0)
    log(f"[main] scene {scene.ortho.shape} + runner in "
        f"{time.time() - t0:.1f} s")
    errors = []

    def run_frame(i: int, tag: str = "") -> float:
        ms, err = fly(runner, scene, i, tag and f"[main] {tag} bucket "
                      f"{round(scene.yaws[i] / 15.0)}")
        errors.append(err)
        return ms

    # one untimed frame loads the kernels and warms the allocator; the
    # counts start at 0 after it
    run_frame(0)

    # the main path: 8 frames over 3 buckets, the counts read after them
    reset_launches()
    for i in range(len(yaws)):
        run_frame(i, f"frame {i}")
    launches = dict(LAUNCHES)
    log(f"[main] launches over {len(yaws)} frames: {launches}")
    missing = [k for k in PATH1_KERNELS if launches[k] == 0]
    if missing:
        raise RuntimeError(f"main path never launched {missing}")

    # timing window. Refresh: one frame per bucket of 7, cycled; more
    # buckets than the 4-entry LRU in a fixed order miss on every frame
    # after the first cycle, so the 2 cycles after it are all refreshes.
    # Cached: then the frames of the last 4 buckets, cycled, all hits.
    cycle = [0, 3, 5] + list(range(len(yaws), len(scene.yaws)))
    for i in cycle:
        run_frame(i)
    refresh_ms = [run_frame(i) for i in cycle * 2]
    last4 = cycle[-4:]
    cached_ms = [run_frame(last4[j % 4]) for j in range(CACHED_FRAMES)]
    p50 = float(np.median(cached_ms))
    out = {"frame_p50_ms": p50,
           "frame_p90_ms": float(np.percentile(cached_ms, 90)),
           "refresh_frame_p50_ms": float(np.median(refresh_ms)),
           "bucket_refresh_ms": float(np.median(refresh_ms)) - p50,
           "cached_frames": len(cached_ms), "refresh_frames": len(refresh_ms),
           "fixes": len(errors), "max_error_m": float(max(errors)),
           "mean_error_m": float(np.mean(errors)), "launches": launches}
    if profile_run:
        busy = profile_frames(run_frame, last4)
        out["device_busy_ms"] = busy
        out["device_idle_share"] = 1.0 - busy / p50
    log("[main] " + json.dumps(out))
    out["scene"], out["params"], out["config"] = scene, params, config
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only, no timing")
    ap.add_argument("--kernels", action="store_true",
                    help="build, check and time the kernels, drive no path "
                         "(to compare two sources of a kernel in one call)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile paths 1-5 (torch.profiler)")
    ap.add_argument("--seed-spread", action="store_true",
                    help="only print how the cached runner's fixes move "
                         "over RANSAC seeds")
    ap.add_argument("--digest", action="store_true",
                    help="only print the sha256 of the stem's, NMS "
                         "kernels' and shear's outputs on seeded inputs")
    args = ap.parse_args(argv)

    t_start = time.time()
    device = phase_device()
    from gisnav_tpu_torch.device import strict_fp32

    strict_fp32()
    phase_build()
    if args.seed_spread:
        phase_seed_spread()
        return 0
    if args.digest:
        phase_digest()
        return 0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results: list = []
    check_conv(gen, args.quick, results)
    check_nms(gen, args.quick, results)
    check_block(gen, args.quick, results)
    check_attention(gen, args.quick, results)
    check_shear(gen, args.quick, results, ab=args.kernels)
    check_cellmax(gen, args.quick, results)
    torch.cuda.synchronize()
    log(json.dumps({"kernels_checked": [r["name"] for r in results]}))
    if args.quick:
        return 0
    if args.kernels:
        log(json.dumps({"kernel_times": [
            {k: r[k] for k in ("name", "ms", "plain_ms", "library_ms",
                               "bound_ms", "max_abs_err", *EXTRA_KEYS)
             if k in r}
            for r in results]}))
        return 0
    log(f"[phase] kernels done at {time.time() - t_start:.1f} s")
    main_path = phase_main_path(args.profile)
    params, config = main_path["params"], main_path["config"]
    log(f"[phase] path 1 done at {time.time() - t_start:.1f} s")
    cached = phase_cached_path(params, config, args.profile)
    log(f"[phase] path 2 done at {time.time() - t_start:.1f} s")
    exact = phase_exact_warp_path(params, config, main_path["scene"],
                                  args.profile)
    log(f"[phase] path 3 done at {time.time() - t_start:.1f} s")
    harris = phase_harris_path(args.profile)
    log(f"[phase] path 4 done at {time.time() - t_start:.1f} s")
    phase_semidense_path(args.profile)
    log(f"[phase] path 5 done at {time.time() - t_start:.1f} s")
    # each kernel's count comes from the path that runs it
    counts = dict(main_path["launches"])
    counts["masked_attention"] = cached["module"]["launches"][
        "masked_attention"]
    for name in ("shear_last_axis", "shear_first_axis"):
        counts[name] = exact["zoomless"]["launches"][name]
    counts["nms_cellmax"] = phase_cellmax_stage()
    for r in results:
        r["launches"] = counts[r["name"]]
        if not r["launches"] > 0:
            raise RuntimeError(f"{r['name']} was launched on no path")
        if r["name"] in PATH1_KERNELS:
            r["path4_launches"] = sum(harris[m]["launches"][r["name"]]
                                      for m in ("cached", "bucketed",
                                                "exact"))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"kernels": [
        {**{k: r.get(k) for k in keys},
         **{k: r[k] for k in EXTRA_KEYS if k in r}}
        for r in results]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
