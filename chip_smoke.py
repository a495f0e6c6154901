#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (keyhuntm1cpu_tpu_torch).

    python3 chip_smoke.py [--m 268435456] [--seconds 10]

Needs one NVIDIA GPU (sm_90a), nvcc and g++. Phases, one progress line each;
any failure exits non-zero before the result line:

0. card and build: the card's name and power limit; the CUDA kernels
   (csrc/*.cu) and the native host library are built from this checkout.
1. each kernel against its plain torch version on the card, at the shapes
   the main path gives it (K1 advance chain, K2 walk blocks, K3 insert keys),
   plus K1 against ecref with P == ADV and P == -ADV lanes, K2 with planted
   dx == 0 lanes, K3 also against np.bitwise_or.at; each kernel timed beside its
   plain version with CUDA events.
2. a small end-to-end: m = 2^20, three planted keys, all found exactly.
3. the main path at real state size (the bench.py protocol): host-resolve
   BSGS at m = 2^28 with the 2^35-bit bitmap and 2^35-bit bloom2 on the card,
   U = 16384, K = 256, build_block = 4096; the native host table built and
   prefaulted; the streaming filter build timed; puzzle 63's key recovered
   bit-exact from a +-3 step window; then --seconds of throughput on the
   puzzle-64 range, in keys/s = chunks*K*U*2m/s, with the device's idle share
   over that window (CUDA events around each chunk), then the chunk time
   split over K1, K2, cascade and host decode.
4. the launch counts of phase 3's main path (filter build and the two
   searches, counted from zero): every kernel launched, and each stage
   launched exactly the kernels it should.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import json
import os
import subprocess
import sys
import time

PUZZLE63_KEY = 0x7CCE5EFDACCF6808
PUZZLE64_KEY = 0xF7051F27B09112D4
U, K, BUILD_BLOCK = 16384, 256, 4096  # bench.py's main-path shape
MAIN_BITS = 35  # bitmap and bloom2 sizes of the main path (4 GiB each)
SMALL_M = 1 << 20  # phase 2
K3_BITS, K3_KEYS = (24, 35), 1 << 22  # phase 1 K3 checks
KERNEL_SOURCES = {
    "advance_chain": ("keyhuntm1cpu_tpu_torch/csrc/pwalk.cu",
                      "keyhuntm1cpu_tpu/curve/pwalk.py:96"),
    "walk_blocks": ("keyhuntm1cpu_tpu_torch/csrc/pwalk.cu",
                    "keyhuntm1cpu_tpu/curve/pwalk.py:195"),
    "insert_keys": ("keyhuntm1cpu_tpu_torch/csrc/filter.cu",
                    "keyhuntm1cpu_tpu/engine/bsgs.py:1644"),
}


def log(msg):
    print(f"[smoke] {msg}", flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "nvidia-smi failed"


def timed(fn, reps):
    """Mean milliseconds of fn() over reps runs after one warm-up run,
    by CUDA events."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def max_abs_err(got, want):
    import torch

    err = 0
    for g, w in zip(got, want):
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def phase1_kernels(dev, results):
    import numpy as np
    import torch

    from keyhuntm1cpu_tpu_torch.curve import pwalk, tables
    from keyhuntm1cpu_tpu_torch.engine.bsgs import BUILD_BLOCKS
    from keyhuntm1cpu_tpu_torch.field import fe
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp
    from keyhuntm1cpu_tpu_torch.ref import ecref

    def limbs(v):
        return torch.from_numpy(fe.int_to_limbs(v).view(np.int32).copy())

    def cols(pts):
        return (torch.stack([limbs(p[0]) for p in pts]).t().contiguous().to(dev),
                torch.stack([limbs(p[1]) for p in pts]).t().contiguous().to(dev))

    stride = 2 * (1 << 28)  # the main path's m
    adv = ecref.point_neg(ecref.scalar_mult(U * stride))  # the search ADV = U*S
    adv_k = (-U * stride) % ecref.N
    ax, ay = limbs(adv[0]).to(dev), limbs(adv[1]).to(dev)

    # K1 at T=1 (against its plain version and ecref) and T=16 (against
    # ecref); lane 0 of T=16 starts at ADV (doubling), lane 1 at -3*ADV
    # (P == -ADV at step 3)
    for T in (1, 16):
        ks = [0x1234567890ABCDEF + 99991 * t for t in range(T)]
        if T == 16:
            ks[0], ks[1] = adv_k, (-3 * adv_k) % ecref.N
        px, py = cols([ecref.scalar_mult(k) for k in ks])
        ms, got = timed(lambda: pwalk.advance_chain(px, py, ax, ay, K), 5)
        if T == 1:  # the main path's shape; the plain version takes a minute
            pms, want = timed(lambda: pwalk.advance_chain_ref(px, py, ax, ay, K), 1)
            k1_ms, k1_plain, k1_err = ms, pms, max_abs_err(got, want)
            if k1_err:
                fail("K1 advance_chain differs from its plain version")
        bx = got[0].cpu().numpy().view(np.uint32)
        adeg = got[4].cpu().numpy()
        for t, k in enumerate(ks):
            pt = ecref.scalar_mult(k)
            for s in range(K):
                if T == 16 and t == 1 and s >= 3:
                    break
                if fe.limbs_to_int(bx[:, t * K + s]) != pt[0]:
                    fail(f"K1 base t={t} s={s} differs from ecref")
                pt = ecref.point_add(pt, adv)
        want_flags = np.zeros((T, K), bool)
        if T == 16:
            want_flags[1, 2] = True
        if not np.array_equal(adeg, want_flags):
            fail(f"K1 P == -ADV flags wrong at T={T}")
        log(f"K1 advance_chain T={T} K={K}: equal to "
            f"{'plain and ' if T == 1 else ''}ecref; {ms:.3f} ms")
    log(f"K1 plain version at T=1: {k1_plain:.1f} ms")
    results["advance_chain"] = dict(max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain)

    # K2 at R=K=256, U=16384 (T=1) over every lane, with planted dx == 0
    s_pt = ecref.point_neg(ecref.scalar_mult(stride))
    tab_x, tab_y = tables.step_table(s_pt, U)
    tx = pwalk.table_to_limb_major(tab_x, dev)
    ty = pwalk.table_to_limb_major(tab_y, dev)
    px, py = cols([ecref.scalar_mult(0x7CCE5EFDACCF6808 - 12345)])
    bx, by, _, _, _ = pwalk.advance_chain(px, py, ax, ay, K)
    # one base == tab[u1] and one == -tab[u2]: dx == 0 at those lanes
    plants = ((K // 32, U // 164, 1), (K * 25 // 32, U * 5 // 16, -1))
    for col, u, sign in plants:
        y = fe.limbs_to_int(tab_y[u])
        bx[:, col] = limbs(fe.limbs_to_int(tab_x[u])).to(dev)
        by[:, col] = limbs(y if sign > 0 else ecref.P - y).to(dev)
    pms, want = timed(lambda: pwalk.walk_blocks_ref(bx, by, tx, ty), 1)
    ms, got = timed(lambda: pwalk.walk_blocks(bx, by, tx, ty), 5)
    k2_err = max_abs_err(got, want)
    if k2_err:
        fail("K2 walk_blocks differs from its plain version")
    deg = got[2].cpu().numpy()
    if not all(deg[col, u] for col, u, _ in plants):
        fail("K2 planted dx == 0 lanes not flagged")
    log(f"K2 walk_blocks R={K} U={U}: equal to plain over every lane, "
        f"dx==0 flagged; {ms:.3f} ms (plain {pms:.1f} ms)")
    results["walk_blocks"] = dict(max_abs_err=k2_err, ms=ms, plain_ms=pms)

    # K3 against its plain version and np.bitwise_or.at on 4M random keys
    # at each size; timed at the streaming build's shape on 2^35-bit filters
    rng = np.random.default_rng(7)
    n = K3_KEYS
    qhi = torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32)).to(dev)
    qlo = torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32)).to(dev)
    keep = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    kh, kl = bmp.u32(qhi[keep]).cpu(), bmp.u32(qlo[keep]).cpu()
    nb = BUILD_BLOCKS * BUILD_BLOCK  # keys per streaming-build step
    for bits in K3_BITS:
        w1, w2 = bmp.empty_filter(bits, dev), bmp.empty_filter(bits, dev)
        r1, r2 = w1.clone(), w2.clone()
        bmp.insert_keys(w1, bits, w2, bits, qhi, qlo, keep)
        bmp.insert_keys_ref(r1, bits, r2, bits, qhi, qlo, keep)
        if not (torch.equal(w1, r1) and torch.equal(w2, r2)):
            fail(f"K3 insert_keys b={bits} differs from its plain version")
        del r1, r2
        for words, planes in ((w1, bmp.bitmap_bit_planes(kh, kl, bits)),
                              (w2, bmp.bloom2_bit_planes(kh, kl, bits))):
            ref = np.zeros(1 << (bits - 5), np.uint32)
            np.bitwise_or.at(ref, planes[0].numpy(), planes[1].numpy().astype(np.uint32))
            if not np.array_equal(words.cpu().numpy().view(np.uint32), ref):
                fail(f"K3 insert_keys b={bits} differs from np.bitwise_or.at")
            del ref
        ms, _ = timed(lambda: bmp.insert_keys(w1, bits, w2, bits, qhi[:nb],
                                              qlo[:nb], keep[:nb]), 20)
        pms, _ = timed(lambda: bmp.insert_keys_ref(w1, bits, w2, bits, qhi[:nb],
                                                   qlo[:nb], keep[:nb]), 1)
        results["insert_keys"] = dict(max_abs_err=0, ms=ms, plain_ms=pms)
        del w1, w2
        torch.cuda.empty_cache()
    log(f"K3 insert_keys {n} keys at b={K3_BITS}: equal to plain and to "
        f"np.bitwise_or.at; at b={K3_BITS[-1]} {results['insert_keys']['ms']:.3f} ms "
        f"per {nb} keys (plain {results['insert_keys']['plain_ms']:.1f} ms)")
    torch.cuda.synchronize()


def phase2_small(dev):
    from keyhuntm1cpu_tpu_torch.engine.bsgs import BSGSEngine, BSGSParams
    from keyhuntm1cpu_tpu_torch.ref import ecref

    span = K * U * 2 * SMALL_M  # keys per chunk
    a, b = 1 << 44, (1 << 44) + 4 * span
    keys = [a + 12345678901 % span, a + 2 * span + 987654321 % span, b - 5]
    params = BSGSParams(m=SMALL_M, block_u=U, steps_per_chunk=K,
                        build_block=BUILD_BLOCK, chunk_cand_max=1024)
    t0 = time.time()
    eng = BSGSEngine([ecref.scalar_mult(k) for k in keys], a, b, params, device=dev)
    found = sorted(f.private_key for f in eng.search(stop_on_first=False))
    if found != sorted(keys):
        fail(f"phase 2: found {[hex(k) for k in found]}, planted {[hex(k) for k in keys]}")
    log(f"phase 2: m=2^{SMALL_M.bit_length() - 1}, 3 planted keys found exactly in {time.time() - t0:.1f} s")




def launch_counts():
    from keyhuntm1cpu_tpu_torch.curve import pwalk
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp

    wrappers = {"advance_chain": pwalk.advance_chain, "walk_blocks": pwalk.walk_blocks,
                "insert_keys": bmp.insert_keys}
    return wrappers, {name: w.launches for name, w in wrappers.items()}


def delta(after, before):
    return {name: after[name] - before[name] for name in after}


def phase3_main(dev, m, seconds):
    """The main path; returns its launch counts, counted from zero."""
    import torch

    from keyhuntm1cpu_tpu_torch.curve import pwalk
    from keyhuntm1cpu_tpu_torch.engine.bsgs import (BUILD_BLOCKS, BSGSEngine,
                                                     BSGSParams, chunk_impl_host)
    from keyhuntm1cpu_tpu_torch.filter import host_table as ht
    from keyhuntm1cpu_tpu_torch.ref import ecref

    params = BSGSParams(m=m, block_u=U, steps_per_chunk=K, build_block=BUILD_BLOCK,
                        bits_log2=MAIN_BITS, bloom2_bits=MAIN_BITS)
    t0 = time.time()
    htab = ht.ensure_host_table(m, progress=True)
    htab.prefault()
    t_table = time.time() - t0
    log(f"phase 3: host table m=2^{m.bit_length() - 1} ready in {t_table:.1f} s "
        f"(native build + prefault)")
    pub63 = ecref.scalar_mult(PUZZLE63_KEY)

    # the main path's run: every launch from here to the end of the
    # throughput window is counted
    wrappers, _ = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    eng = BSGSEngine([pub63], 1 << 63, 1 << 64, params, device=dev, host_table=htab)
    torch.cuda.synchronize()
    t_build = time.time() - t0
    _, n_build = launch_counts()
    build_steps = max(0, -(-(m - 2 * BUILD_BLOCK) // (BUILD_BLOCKS * BUILD_BLOCK)))
    want = dict(advance_chain=build_steps, walk_blocks=build_steps,
                insert_keys=build_steps + 1)  # + the native seed's insert
    if n_build != want:
        fail(f"streaming build launched {n_build}, expected {want}")
    log(f"phase 3: streaming filters (bits={eng.bitmap.bits_log2}, "
        f"b2={eng.bloom2.bits_log2}, {2 * eng.bitmap.words.numel() * 4 / 2**30:.0f} GiB) "
        f"built on the card in {t_build:.1f} s; launches {n_build}")

    window = U * eng.stride
    eng63 = BSGSEngine([pub63], PUZZLE63_KEY - 3 * window, PUZZLE63_KEY + 3 * window,
                       params, device=dev, host_table=htab, bitmap=eng.bitmap,
                       bloom2=eng.bloom2)
    t0 = time.time()
    found = [f.private_key for f in eng63.search()]
    if found != [PUZZLE63_KEY]:
        fail(f"puzzle-63 recovery failed: {[hex(k) for k in found]}")
    _, n63 = launch_counts()
    d63 = delta(n63, n_build)
    if d63["insert_keys"] or d63["advance_chain"] < 1 or d63["walk_blocks"] != d63["advance_chain"]:
        fail(f"puzzle-63 search launched {d63}, expected K1 == K2 >= 1 and no K3")
    log(f"phase 3: puzzle-63 key 0x{PUZZLE63_KEY:x} recovered bit-exact in "
        f"{time.time() - t0:.2f} s; launches {d63}")

    # throughput; a CUDA event pair around each chunk's work on the stream
    # gives the device's busy time (the summary copies fall in the gaps)
    eng64 = BSGSEngine([ecref.scalar_mult(PUZZLE64_KEY)], 1 << 63, 1 << 64, params,
                       device=dev, host_table=htab, bitmap=eng.bitmap, bloom2=eng.bloom2)
    marks, enqueue = [], []
    chunk_fn = eng64._chunk_fn

    def marked_chunk(px, py):
        t = time.perf_counter()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = chunk_fn(px, py)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record()
        marks.append((ev0, ev1))
        enqueue.append(time.perf_counter() - t)
        return out

    eng64._chunk_fn = marked_chunk
    torch.cuda.synchronize()
    t0 = time.time()
    found = eng64.search(max_seconds=seconds)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    _, n_main = launch_counts()
    d64 = delta(n_main, n63)
    chunks = eng64.stats.keys_covered // (K * U * eng64.stride)
    if d64 != dict(advance_chain=len(marks), walk_blocks=len(marks), insert_keys=0) \
            or chunks != len(marks):
        fail(f"throughput search launched {d64} for {len(marks)} chunks dispatched, "
             f"{chunks} counted")
    keys_per_sec = eng64.stats.keys_covered / elapsed
    busy = sum(a.elapsed_time(b) for a, b in marks)
    span = marks[0][0].elapsed_time(marks[-1][1])
    log(f"phase 3: throughput {chunks} chunks in {elapsed:.2f} s -> "
        f"{keys_per_sec:.4e} keys/s (= chunks*K*U*2m/s; K={K}, U={U}, "
        f"m=2^{m.bit_length() - 1}); {len(found)} keys found on the way; launches {d64}")
    log(f"phase 3: device idle share {1 - busy / span:.4f} over the window "
        f"(busy {busy:.1f} of {span:.1f} ms between the first chunk's start and the "
        f"last one's end; {busy / chunks:.3f} ms per chunk); host enqueue "
        f"{1000 * sum(enqueue) / chunks:.3f} ms per chunk")

    # chunk-time split by CUDA events: whole chunk, K1 alone, K2 alone;
    # the cascade is the rest; host decode by wall clock
    reps = 10
    px, py = eng64._initial_base(0)
    tot_ms, outs = timed(lambda: chunk_impl_host(
        px, py, eng64.tab_x, eng64.tab_y, eng64.adv_x, eng64.adv_y, eng64.bitmap,
        eng64.bloom2, U=U, K=K, T=1, C1=eng64.C1, C2=eng64.C2), reps)
    pxt, pyt = px.t().contiguous(), py.t().contiguous()
    k1_ms, (bx, by, _, _, _) = timed(
        lambda: pwalk.advance_chain(pxt, pyt, eng64.adv_x, eng64.adv_y, K), reps)
    k2_ms, _ = timed(lambda: pwalk.walk_blocks(bx, by, eng64.tab_x, eng64.tab_y), reps)
    arr = outs[2].cpu().numpy()
    t0 = time.perf_counter()
    for _ in range(reps):
        eng64._consume_summary(0, K, arr)
    dec_ms = (time.perf_counter() - t0) * 1000 / reps
    n_surv = int((arr[: eng64.C2] < K * U).sum())
    log(f"phase 3: chunk {tot_ms:.3f} ms on the card = K1 {k1_ms:.3f} + K2 {k2_ms:.3f} "
        f"+ cascade {tot_ms - k1_ms - k2_ms:.3f}; host decode {dec_ms:.3f} ms "
        f"({n_surv} survivors, C1={eng64.C1}, C2={eng64.C2})")
    log(f"phase 3: device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated, {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak; "
        f"card {card_line()}")
    return n_main


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=1 << 28,
                    help="baby-table size of phase 3 (default 2^28; 2^30 fits)")
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="throughput window of phase 3")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs an NVIDIA GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "keyhuntm1cpu_tpu_torch")):
        fail("run from a checkout of the repository (keyhuntm1cpu_tpu_torch/ missing)")
    sys.path.insert(0, here)
    from keyhuntm1cpu_tpu_torch import _build

    card = card_line()
    log(f"phase 0: card {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")
    t0 = time.time()
    _build.kernels()
    t_cuda = time.time() - t0
    t0 = time.time()
    _build.host_lib()
    log(f"phase 0: built CUDA kernels in {t_cuda:.1f} s, native host library in "
        f"{time.time() - t0:.1f} s")

    results = {}
    phase1_kernels(dev, results)
    phase2_small(dev)
    launches = phase3_main(dev, args.m, args.seconds)
    if not all(launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")
    log(f"phase 4: launches on the main path {launches}")

    kernels = [dict(name=name, route="cuda", source=KERNEL_SOURCES[name][0],
                    replaces=KERNEL_SOURCES[name][1], launches=launches[name],
                    max_abs_err=results[name]["max_abs_err"], ms=results[name]["ms"],
                    plain_ms=results[name]["plain_ms"]) for name in launches]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
