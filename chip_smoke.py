#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (keyhuntm1cpu_tpu_torch).

    python3 chip_smoke.py [--m 268435456] [--seconds 10]

Needs one NVIDIA GPU (sm_90a), nvcc and g++. Phases, one progress line each;
any failure exits non-zero before the result line:

0. card and build: the card's name, power limit and SM clock; the CUDA
   kernels (csrc/*.cu, one nvcc each, in parallel) and the native host
   library are built from this checkout; ptxas's registers and spills of
   each kernel.
1. each kernel against its plain torch version on the card, at the shapes
   the main paths give it (K1 advance chain, K2 walk blocks, K3 insert keys,
   K4 brute walk, K5 minikey validity, the minikey compaction and key
   derivation, K6 scalar-mult ladder in its own order, K7 and K8 hash160),
   plus K1 against
   ecref at T = 1
   and 16 with P == j*ADV (doubling lanes: j = 1, K/2) and P == -j*ADV
   (infinity lanes: j = 3, K) planted, with the paired walk's centre lanes
   as the BSGS chunk runs K1 (every centre against ecref, and row 0's at
   infinity planted) and without them, K1 and K2 also at the filter
   build's shape (K = 128; R = 128, U = 4096), K2 as the chunk runs it,
   the paired walk over K1's centres, with planted dx == 0 lanes at block
   edges and, apart, every rare lane of tests/pair_walk_model.py (base =
   +-tab_u, a pair with dx == 0, base = +-c*S, bases off the curve, x3
   below 2^32 + 977, dy == 0; the planted rows' centres by K1 at K = 1),
   beside K2 a point a thread on the same bases, K2 with the level-1 probe
   (the BSGS chunk's form: its walk held to the plain version's, its
   survivor mask to the plain version's and the mask's compaction,
   kh_mask_compact, to kh_probe_compact's over the same keys, each timed),
   K3 also
   against np.bitwise_or.at, with its degeneracy count (degenerate lanes
   planted inside and past the kept prefix) and in its bitmap-only and
   bloom-only forms (the bloom alone also at 2^32 bits, a device table's),
   timed at the build step beside the card's random atomicOr ceiling
   (scripts/torch_filter_shapes.py), K4 in every mode, with the
   endomorphism and
   with a bucketed T = 4096 set, all at K = 256 (planted hits and dx == 0
   lanes), and rmd160 with real intervals (bench_vanity's 9 for key 777's
   prefix beside 3 point targets; every interval hit checked on the host);
   the fused chunk's compaction and summary (kh_compact_hits) at
   C = 1024 on K4's rmd160 hit words and on planted ones (R + 1 flagged
   rows, more than C words in R rows, a dense row and degenerate words),
   three launches in a row on each, with its device operations;
   K5 over every lane of B = 2^23 in the canonical and a custom
   alphabet and against hashlib on a sample, the compaction and key
   derivation (on K5's mask and on planted ones: none valid, more valid
   lanes than V, lanes at every tile edge, B not a multiple of the tile),
   K6 (edge
   scalars planted, x, y, inf and irr equal to scalar_mult_split_ref, every
   unflagged lane against ecref), K7 and K8 at V = 34,816; the
   walker path's kernels at its main-path shapes (W = 8, U = 4096,
   chain_len = 32, and 33 for walk_emit): walk_prefix and walk_emit with
   C == ADV, C == -ADV and
   dx == 0 lanes, pinv on the step's 1,025 chain totals with zeros planted
   (every column checked as an inverse; beside it the four pinv designs of
   scripts/torch_pinv_shapes.py at that width), Keccak ETH, K7 and K8 on
   the step's 65,544 points, the probe on 131,088 rmd160 queries against a
   2^34-bit bitmap (beside words[idx], one torch index), in its fused form
   (ordered compaction to cand_max = 256) and in bloom2 form at phase 3's
   sizes, walk_prefix also at L = 7, 64 and 65, and the step's lookup and
   summary (C = 256 survivors over 2^22 table keys, hits planted on
   degenerate lanes and a duplicated key; beside sorted_table.lookup, the
   torch.searchsorted composition, and its latency floor at C = 1, W = 1,
   warm and with a cold L2; then the cases of tests/walker_lookup_cases.py,
   the 32-ary search's edges among them);
   the BSGS chunk's bloom2 stage (kh_bloom2_compact: C1 = 34,816 stage-1
   survivors of 4,194,304 queries into C2 = 1,536 against host resolve's
   2^35-bit and a device table's 2^32-bit bloom2, at their densities and
   at a stage-2 overflow; also at m = 2^30's C1 = 134,656, and after a
   zero fill of its scratch, one more device operation as PR 16's memset
   was) and summary
   (kh_bsgs_summary in both resolve modes and the ring's two forms: C2
   survivors over 256 rows of U = 16,384 and a 2^28-key table, flags and
   hits planted; also with a cold L2 and at m = 2^30's survivors), each
   beside the torch composition it replaced; the compact kernels'
   scratch pairs reused by 1,200 launches on two streams with no memset
   (C1 between tile boundaries; 200 of kh_compact_hits interleaved with
   the probe's two forms on each stream), each equal to its plain version;
   each kernel's device time
   (device_ms: CUDA events around back-to-back runs queued behind a sleep
   kernel) beside its plain version's time.
2. a small end-to-end: m = 2^20, three planted keys, all found exactly,
   in host and in device resolve.
3. the main path at real state size (the bench.py protocol): host-resolve
   BSGS at m = 2^28 with the 2^35-bit bitmap and 2^35-bit bloom2 on the card,
   U = 16384, K = 256, build_block = 4096; the native host table built and
   prefaulted; the streaming filter build timed; puzzle 63's key recovered
   bit-exact from a +-3 step window; then --seconds of throughput on the
   puzzle-64 range (every chunk decoded: the window may reach puzzle 64's
   key, or the range's end), in keys/s = chunks*K*U*2m/s, with the device's
   idle share over that window (CUDA events around each chunk), then the
   chunk time split over K1, K2, cascade and host decode (on the card:
   device_ms) and over K1, K2, the probe, the bloom2 stage and the
   summary (chunk_split; also one chunk at m = 2^30 on filters streamed
   on the card, held to its plain versions, phase3_m30), one
   streaming-build step's device operations
   (torch.profiler) and card time; one chunk through the kernels held
   to the same chunk through the plain versions (chunk_composition) and
   beside the torch route (the earlier chunk: torch ops after the level-1 probe): each one's
   device operations (torch.profiler), enqueue and card ms a chunk, and
   5 s of keys/s of the engine on the torch route; the cascade of one chunk's
   T*K*U queries through the fused probe (probe_compact) and the bloom2
   probe held to the same cascade through their plain versions and to the
   composition the fusion replaced; the level-1 stage timed beside that
   composition, the card's random-read ceiling at 2^34 and 2^35 bits
   (scripts/torch_probe_shapes.py) and words[idx] (the probe's entry in
   the kernels line). Then bsgs_t16 (bench_modes.bench_bsgs_multitarget)
   on phase 3's host table and filters: 16 planted keys in one 8-step
   window all recovered, then 5 s at K = 32, T = 16.
3s. scheduled BSGS (search_scheduled) on phase 3's table and filters: a
   random order over 8 chunks stopped after 4 and resumed by a fresh engine
   from its checkpoint (puzzle 63's key in the order's second half, found
   once, every chunk covered once), then 5 s of -B random and 5 s of -B
   sequential over the puzzle-64 range: keys/s, the idle share, the host's
   enqueue and rebase a chunk (the host-table bases, beside _initial_base).
3d. device-resolve BSGS at phase 3's shape (bench.py with
   BENCH_RESOLVE=device): the baby table built on the card (the K1/K2 walk
   of the filter build, one stable sort; checked sorted, j = 1..m and on
   64 entries against ecref), the 2^35-bit bitmap and the 2^32-bit bloom2
   from it by K3, timed apart; puzzle 63's key from a +-3 step window;
   --seconds of throughput (keys/s, idle share, host enqueue and decode a
   chunk); one chunk through the kernels held to the same chunk through
   their plain versions and beside the torch route, as in phase 3, and its
   card time split over K1, K2 and the cascade with the exact search and
   the summary; device memory. Then bsgs_t16 on its table; then, after
   phase 3b, one chunk at m = 2^29 and 2^30 each (table build, memory, the
   survivors a chunk against C1 and C2: the bloom2 is capped at 2^32 bits).
3b. bsgsd (server.py) on phase 3d's resident table, on localhost: puzzle
   63's key, a miss (404), a zero deadline (408) and, one chunk a turn, a
   one-chunk request queued behind a 64-chunk one answered first.
3f. the fleet on the card: a coordinator (dist/coordinator.py) in this
   process over puzzle 63's whole range [2^62, 2^63) in 16 units of 128
   chunks at phase 3d's shape, one ghost lease backdated and reclaimed, the
   port's worker CLI (python -m keyhuntm1cpu_tpu_torch.dist.worker) as a
   subprocess building its own resident table, stopped by SIGTERM
   partway through its fifth unit (reported failed, requeued), and a
   second worker process finishing the range: all 16 units completed,
   puzzle 63's key found once, no unit covered twice but the requeued one;
   the fleet's keys/s beside phase 3d's, each unit's overhead (RPCs,
   engine, _initial_base) beside its chunks, each worker's table build and
   launch counts.
4. the brute-force path (bench_modes.py's protocol) in rmd160, xpoint,
   eth, address_u, rmd160 -e and rmd160 with T = 4096 bucketed targets:
   keys 1..32 recovered bit-exact over [1, 4097) at U = 256, K = 4
   (U = 1024 bucketed), then 5 s of throughput at U = 16384,
   K = 256, T = 32 over [2^40, 2^40 + 2^50): effective keys/s (keys times
   the mode's multiplier), the device idle share, the host's enqueue time
   a chunk, the device operations of one chunk and the memsets among them
   (torch.profiler), the chunk time split over K1, K4 and the compaction,
   and K1 == K4 == compaction == chunks dispatched.
4v. vanity (bench_modes.bench_vanity's protocol): key 777's 5-character
   prefix over [1, 2049) at U = 256, K = 4, the found set equal to a host
   scan's; the prefix beside keys 1..32 over [1, 4097); then 5 s at
   U = 16384, K = 256 over phase 4's range: effective keys/s, candidates
   a chunk, the idle share, the card's chunk, the host's enqueue, decode
   and check a chunk (the check's K6 batches beside two and one ecref
   scalar mults a candidate), K1 == K4 == compaction == chunks and K6 ==
   batches.
4b. the minikeys path (bench_modes.py's protocol, B = 2^23, V = 34,816,
   HM = 64, prefix "Sbenchmark1x"): the planted minikey recovered
   bit-exact in one chunk, then 5 s of throughput from counter 2^31 with
   1 target and with 2^20 decoy hash160 targets: minikeys/s, the device
   idle share, the chunk's device operations (torch.profiler), the chunk
   time split over K5, the compaction and keys (one kernel), K6, K7 + K8
   and lookup + summary, and K5 == compaction == K6 == K7 == K8 == chunks
   dispatched.
4r. kill and resume at full width: fused rmd160 (T = 32, keys in chunks 0
   and 3: 2 chunks, then a fresh engine from the checkpoint for 2 more),
   minikeys at B = 2^23 (one chunk, then the prefix and counter adopted
   and 2 more), and, in phase 4c, the walker path (one chunk, then one).
4f. fleet brute and fleet minikeys in this process: dist.worker's
   brute_search_fn in rmd160 at phase 4's shape (T = 32) over 4 units of 2
   chunks with keys planted in units 1 and 3, and minikeys_search_fn at
   B = 2^23 over 4 counter units of one chunk with the first valid minikey
   of unit 2 planted; every planted key found once, launches counted.
4c. the large-target brute path (the walker path, taken past bucket_max
   targets): keys 1..32 recovered bit-exact over [1, 4097) at W = 2,
   U = 256, K = 4 in rmd160, xpoint, eth, address_u, rmd160_both and
   rmd160 / xpoint -e (with lambda*k keys planted); then T = 2^22 targets
   (an address list and an ETH list, parsed from files: 2^22 - 32 seeded
   decoys and 32 planted keys in the first chunk of walkers 0 and 7; the
   bitmap built on the card by K3, checked once word for word against the
   host build outside the timed set-up), the JAX CLI's shape W = 8,
   U = 4096, K = 8, over [2^40, 2^40 + 2^50): the planted keys recovered in one chunk, then 5 s of throughput per mode
   with effective keys/s, the device idle share, host enqueue per chunk,
   the device operations of one chunk (torch.profiler), the chunk split
   over walk_prefix, pinv, walk_emit, hash, probe with its compaction,
   lookup and summary, and the rest (torch work left), set-up
   times, device memory and launch counts.
5c. the CLI on the card, as subprocesses: -m bsgs --config (m = 2^28, U,
   K from the file) --metrics-port --notify-cmd over puzzle 63's +-3-step
   window (/metrics.json polled during the run up to the engine's count,
   /metrics parsed as Prometheus text, /healthz ok, the notify script given
   the key); -m rmd160 -S over phase 4's range at T = 32 writing
   data_<8hex>.dat and a second run reading it back; -z 4 at m = 2^24
   (the bitmap at scaled_bits_log2(2^24, 4) bits).
5l. the legacy export at keyhunt's default size m = 2^22: x32 by K6 on the
   card (utils/legacy.baby_x_bytes), the three .blm levels and the .tbl
   timed apart, verify_against_ecref(probes=64), 256 random rows against
   ecref and the first 2^12 against the host walk, the file sizes; the
   native bulk parse of a 2^18-line address file beside the python parse
   of its first 2^14 lines.
6. the multi-device engines (parallel/), on the visible cards repeated up
   to 4 shards (distinct cards where several are visible), each shard's
   device printed:
6a. range-sharded BSGS at phase 3d's width on its resident table, bitmap
   and bloom2 (no second build): the first sharded chunk's 4 summaries
   word for word the single-device chunk at each slice's base; puzzle
   63's key from a window in the last shard's slice; 5 s on puzzle 64's
   range: keys/s beside phase 3d's, the idle share, the host's enqueue a
   sharded chunk, peak memory.
6b. table-sharded BSGS at m = 2^28 over 4 shards sliced from that table,
   all_gather and ring: the shard build (bitmaps and bloom2s by K3) timed,
   its memory; the probers' live hits of the first chunk equal to the
   single-device chunks' for each source slice (all_gather), the ring's
   first chunk equal to all_gather's as a set; puzzle 63's key; 5 s each.
6c. range-sharded brute rmd160 at phase 4's shape (T = 32) over 4 shards:
   32 planted keys, 8 a shard; 5 s of effective keys/s beside phase 4's.
6d, 6e. at m = 2^24, five subprocesses together: two multihost processes
   (dist/multihost.py, gloo rendezvous; one with --sharded) reporting the
   key once to a coordinator here; the CLI with --sharded range and with
   --sharded table --table-comm ring, each finding puzzle 63's key, and
   --resolve host --sharded, which exits 2.
7. the port's bench entry (python -m keyhuntm1cpu_tpu_torch.bench) in a
   subprocess at m = 2^22, host resolve, 2 s of headline and 1 s a mode
   section: rc 0, puzzle 63's gate and every section's gate ok in its last
   line, every section named, its device the card, and its own launch
   counts showing every kernel of its path; the line is printed.
5. the launch counts of the main paths (phase 3's filter build and
   searches, phase 3d's table and filter builds and searches, the
   throughput windows of both bsgs_t16 runs and of phases 3s, 4, 4v, 4b,
   4c, 6a, 6b (both schedules) and 6c, the fleet phases 3f (the workers'
   own counts) and 4f and the x32 of phase 5l, each counted from zero):
   every kernel launched, and each stage launched exactly the kernels it
   should (3, 3d, 3s, bsgs_t16: K1, K2, the level-1 probe, the bloom2
   stage and the summary of the resolve mode a chunk; 6a, 6b the same a
   shard chunk, the ring's probes, bloom2 stages and summaries D times and
   one more summary a prober; 6c: K1, K4 and the compaction a shard chunk).

The line before the last is {"kernels": [...]} with each kernel's bound
(the larger of its 32-bit integer operations over the card's INT32 issue
rate and its bytes over the memory rate); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

PUZZLE63_KEY = 0x7CCE5EFDACCF6808
PUZZLE64_KEY = 0xF7051F27B09112D4
PUZZLE64_RANGE = (1 << 63, 1 << 64)
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
    "brute_walk_blocks": ("keyhuntm1cpu_tpu_torch/csrc/pbrute.cu",
                          "keyhuntm1cpu_tpu/curve/pbrute.py:70"),
    "compact_hits": ("keyhuntm1cpu_tpu_torch/csrc/compact.cu",
                     "keyhuntm1cpu_tpu/curve/pbrute.py:300"),
    "minikey_valid": ("keyhuntm1cpu_tpu_torch/csrc/minikey.cu",
                      "keyhuntm1cpu_tpu/hash/pminikey.py:128"),
    "minikey_compact_keys": ("keyhuntm1cpu_tpu_torch/csrc/minikey.cu",
                             "keyhuntm1cpu_tpu/engine/minikeys.py:458"),
    "scalar_mult": ("keyhuntm1cpu_tpu_torch/csrc/ladder.cu",
                    "keyhuntm1cpu_tpu/curve/pladder.py:187"),
    "hash160_x2": ("keyhuntm1cpu_tpu_torch/csrc/phash.cu",
                   "keyhuntm1cpu_tpu/hash/phash.py:136"),
    "hash160_u": ("keyhuntm1cpu_tpu_torch/csrc/phash.cu",
                  "keyhuntm1cpu_tpu/hash/phash.py:421"),
    "inv_batch": ("keyhuntm1cpu_tpu_torch/csrc/pinv.cu",
                  "keyhuntm1cpu_tpu/field/pinv.py:26"),
    "keccak_eth": ("keyhuntm1cpu_tpu_torch/csrc/phash.cu",
                   "keyhuntm1cpu_tpu/hash/phash.py:321"),
    "probe": ("keyhuntm1cpu_tpu_torch/csrc/probe.cu",
              "keyhuntm1cpu_tpu/filter/bitmap.py:280"),
    "walk_prefix": ("keyhuntm1cpu_tpu_torch/csrc/walk.cu",
                    "keyhuntm1cpu_tpu/curve/walk.py:144"),
    "walk_emit": ("keyhuntm1cpu_tpu_torch/csrc/walk.cu",
                  "keyhuntm1cpu_tpu/curve/walk.py:144"),
    "lookup_summary": ("keyhuntm1cpu_tpu_torch/csrc/lookup.cu",
                       "keyhuntm1cpu_tpu/engine/brute.py:1064"),
    "bloom2_compact": ("keyhuntm1cpu_tpu_torch/csrc/probe.cu",
                       "keyhuntm1cpu_tpu/filter/bitmap.py:721"),
    "mask_compact": ("keyhuntm1cpu_tpu_torch/csrc/probe.cu",
                     "keyhuntm1cpu_tpu/filter/bitmap.py:280"),
    "chunk_summary": ("keyhuntm1cpu_tpu_torch/csrc/lookup.cu",
                      "keyhuntm1cpu_tpu/engine/bsgs.py:1662"),
    "chunk_summary_host": ("keyhuntm1cpu_tpu_torch/csrc/lookup.cu",
                           "keyhuntm1cpu_tpu/engine/bsgs.py:1711"),
}
# what a kernel's entry in the kernels line says beyond its numbers
KERNEL_NOTES = {"insert_keys": {"note": "replaces XLA glue, not a Pallas kernel: the bit "
                                        "planes and or_bits_into of the streaming filter "
                                        "build (engine/bsgs.py:1644-1649) and the on-device "
                                        "bitmap build (filter/bitmap.py:74-110); ms at the "
                                        "build step's 524,288 keys into 2^35 + 2^35 bits with "
                                        "its degeneracy count; bound_ms: 64 bytes a random "
                                        "atomic (a DRAM sector read and written back), "
                                        "beside ceiling_ms, the card's random atomicOr "
                                        "ceiling for the same 1,572,864 atomics "
                                        "(scripts/torch_filter_shapes.py); also the "
                                        "bitmap and the bloom2 of a device-resolve table "
                                        "(filter/bitmap.py:162-188, :570-591), in its "
                                        "bitmap-only and bloom-only forms; no torch call "
                                        "ORs into words (scatter_reduce has no OR)"},
                "advance_chain": {"note": "ms: K1 with the paired walk's centre lanes, as "
                                          "the BSGS chunk runs it (T = 1, K = 256: 2K adds, "
                                          "which bound_ms counts); bases_ms: without them, "
                                          "as the brute path runs it"},
                "walk_blocks": {"note": "ms, fused_ms: the paired walk (walk_pairs_kernel) "
                                        "as the BSGS chunk runs it at R = 256, U = 16384, "
                                        "alone and with the level-1 probe; point_ms, "
                                        "point_fused_ms: walk_blocks_kernel, a point a "
                                        "thread, on the same bases (shapes with U % 64 "
                                        "!= 0); bound_ms counts 4 products and a squaring "
                                        "a point (khbench's frozen walk_point_ops), "
                                        "paired_bound_ms the paired walk's 2.5 and a "
                                        "squaring"},
                "minikey_compact_keys": {"note": "replaces XLA glue, not a Pallas kernel: the "
                                                 "count, compaction and key derivation of "
                                                 "_minikey_finish_impl (engine/minikeys.py:"
                                                 "458-479) at B = 2^23, V = 34,816; ms "
                                                 "includes the scratch's memset; no torch call "
                                                 "computes it"},
                "brute_walk_blocks": {"note": "ms, plain_ms, bound_ms: rmd160 at K = 256, "
                                              "U = 16384 against 32 point intervals; "
                                              "vanity_ms, vanity_bound_ms: the same with "
                                              "the 9 real intervals of key 777's 5-character "
                                              "prefix and 3 points (T = 16)"},
                "scalar_mult": {"note": "launches counts K6 calls; a call is two launches, "
                                        "kh_ladder_jac then kh_ladder_affine, and ms "
                                        "times the two together"},
                "probe": {"note": "ms, plain_ms and bound_ms: the fused level-1 form "
                                  "(kh_probe_compact: probe, ordered compaction to C1 and "
                                  "the survivors' keys; no memset, the scratch is left "
                                  "zero) at the BSGS chunk's 4,194,304 "
                                  "queries against 2^35 bits; library_ms: words[idx], "
                                  "the gather alone; launches count the fused, mask and "
                                  "bloom2 forms"},
                "mask_compact": {"note": "the BSGS chunk's level-1 stage since its probe "
                                         "runs in K2 (kh_walk_blocks with a bitmap): the "
                                         "ordered compaction of K2's survivor mask to C1 = "
                                         "34,816 with the survivors' keys, at 4,194,304 "
                                         "queries against 2^35 bits; probe_compact_ms: "
                                         "kh_probe_compact on the same keys, the probe and "
                                         "compaction it replaced in the chunk"},
                "compact_hits": {"note": "replaces XLA glue, not a Pallas kernel: the "
                                         "compaction and summary of pallas_brute_chunk "
                                         "(curve/pbrute.py:300-344), at the fused chunk's "
                                         "K = 256, U = 16384, C = 1024 on K4's rmd160 hit "
                                         "words; no memset (a scratch pair a stream, "
                                         "each launch zeroing the other's ticket); no "
                                         "torch call computes it"},
                "lookup_summary": {"note": "replaces XLA glue, not a Pallas kernel: the "
                                           "summary ops of _brute_chunk_impl "
                                           "(engine/brute.py:1064-1093) and the lower-bound "
                                           "search of filter/sorted_table.py:68; bound_ms: "
                                           "the bytes of the searched keys, beside "
                                           "latency_floor_ms, the kernel at C = 1, W = 1 (one "
                                           "32-ary warp search); cold_ms, "
                                           "latency_floor_cold_ms: the same after a 64 MB "
                                           "fill; library_ms: sorted_table.lookup "
                                           "(torch.searchsorted and the gathers) of the same "
                                           "C = 256 keys over 2^22"},
                "bloom2_compact": {"note": "replaces XLA glue, not a Pallas kernel: the "
                                           "bloom2 stage of filtered_lookup and "
                                           "filtered_survivors (filter/bitmap.py:721-786, "
                                           ":788-824 after the level-1 compaction: the "
                                           "bloom2 probe, the pos1 < B mask, the count, "
                                           "jnp.nonzero, the clamps and gathers, the "
                                           "poison), kh_bloom2_compact in csrc/probe.cu; "
                                           "ms at the main path's C1 = 34,816 stage-1 "
                                           "survivors (32,768 live) into C2 = 1,536 "
                                           "against host resolve's 2^35-bit bloom2 "
                                           "(density 1/64), no memset (the scratch is left "
                                           "zero); with_fill_ms: the same after a zero fill "
                                           "of the scratch, one more device operation as "
                                           "PR 16's memset was; ms_m30, "
                                           "bound_ms_m30, replaced_ms_m30: m = 2^30's C1 = "
                                           "134,656 (131,072 live, density 1/16); "
                                           "replaced_ms: the torch composition it "
                                           "replaced (the bloom2 probe kernel, then torch "
                                           "ops) on the card; no torch call computes it"},
                "chunk_summary": {"note": "replaces XLA glue, not a Pallas kernel: "
                                          "_pallas_chunk_impl after its cascade "
                                          "(engine/bsgs.py:1662-1708: the lane U - 1 "
                                          "fix-up, the live mask, the exact search of "
                                          "filter/sorted_table.py:68, the candidate words, "
                                          "the row summary, the packing), kh_bsgs_summary "
                                          "with a table; ms at C2 = 1,536 survivors (512 "
                                          "of them real) over 256 rows of U = 16,384 and a "
                                          "2^28-key table; cold_ms: the same after a 64 MB "
                                          "fill (the L2 as a chunk's probe leaves it); "
                                          "ms_m30: C2 = 1,536 with m = 2^30's 482 "
                                          "expected survivors; replaced_ms: its torch "
                                          "composition (sorted_table.lookup and the "
                                          "packing ops) on the card; no torch call "
                                          "computes it"},
                "chunk_summary_host": {"note": "replaces XLA glue, not a Pallas kernel: "
                                               "_pallas_chunk_impl_host after its cascade "
                                               "(engine/bsgs.py:1711-1752), kh_bsgs_summary "
                                               "without a table (the keys pass through); "
                                               "the same shapes and readings as "
                                               "chunk_summary; replaced_ms: its torch "
                                               "composition on the card; no torch call "
                                               "computes it"}}
BRUTE_RANGE = (1 << 40, (1 << 40) + (1 << 50))  # bench_modes.py's brute range
BRUTE_SECONDS = 5.0  # throughput window of each phase-4 mode (bench_modes.py's)
MK_BATCH, MK_PREFIX, MK_COUNTER = 1 << 23, "Sbenchmark1x", 1 << 31  # bench_modes.py:154-191
MK_DECOYS = 1 << 20  # a user's list of funded addresses
MK_SECONDS = 5.0  # throughput window of each minikeys target set
MK_CUSTOM = ("abcdefghijkmnopqrstuvwxyz123456789ABCDEFGHJKLMNPQRSTUVWXYZ")  # a -8 alphabet
WK_W, WK_U, WK_K, WK_L = 8, 4096, 8, 32  # the JAX CLI's walker shape (cli.py:85-96)
WK_T = 1 << 22  # targets of the large-target cells: 64x bucket_max
WK_BITS = 34  # their bitmap: default_bits_log2(2^22), the JAX package's cap
WK_SECONDS = 5.0  # throughput window of each phase-4c mode
SCHED_SECONDS = 5.0  # throughput window of each phase-3s range order
T16_SECONDS = 5.0  # throughput window of bsgs_t16 (bench_modes.bench_bsgs_multitarget's)
LARGE_M = (1 << 29, 1 << 30)  # phase 3d's one-chunk readings past the main m
PROBE_BYTES = 32 + 8 + 1  # a random DRAM sector for the word, the key, the mask byte
FLEET_RANGE = (1 << 62, 1 << 63)  # phase 3f: puzzle 63's whole range
FLEET_UNITS = 16  # phase 3f: units of that range, each aligned to one chunk
FLEET_STOP_AFTER = 4  # phase 3f: units the first worker completes before its SIGTERM
X32_M = 1 << 22  # phase 5l: keyhunt's default -n 0x100000000000 with -k 1 (resolve_m)
PARSE_LINES, PARSE_PY_LINES = 1 << 18, 1 << 14  # phase 5l: the address file, its python sample
Z_M = 1 << 24  # phase 5c: the baby-table size of the -z 4 run
SHARDS = 4  # phases 6a-6c, 6e: shards, on the visible cards repeated up to this many
SHARD_SECONDS = 5.0  # throughput window of each phase-6 cell
PREV_SECONDS = 5.0  # phases 3, 3d: the window on the torch route (torch ops after the probe)
CASCADE_C, CASCADE_M = (34816, 1536), 1 << 28  # phase 1: the cascade's C1, C2 and table at m = 2^28
# m = 2^30's host-resolve budgets (BSGSEngine._cascade_budgets, K*U queries
# into 2^35 + 2^35 bits): C1 from 131,072 expected level-1 survivors, C2
# from their 482 expected after the bloom2 (fp 0.0037)
CASCADE_30 = (134656, 1536)
MH_M = 1 << 24  # phases 6d, 6e: the baby-table size of the subprocesses
BENCH_ENV = {"BENCH_M": str(1 << 22), "BENCH_SECONDS": "2", "BENCH_MODE_SECONDS": "1",
             "BENCH_RESOLVE": "host"}  # phase 7
BENCH_SECTIONS = ("bsgs_t16", "rmd160", "xpoint", "eth", "address_u", "minikeys", "vanity",
                  "rmd160_endo", "rmd160_T4096")
BENCH_KERNELS = ("advance_chain", "walk_blocks", "insert_keys", "mask_compact",
                 "bloom2_compact", "chunk_summary_host", "brute_walk_blocks",
                 "compact_hits", "minikey_valid", "minikey_compact_keys", "scalar_mult",
                 "hash160_x2", "hash160_u")  # the kernels of the bench's path

# Bounds. The kernels do 32-bit integer work; an H100 (compute capability
# 9.0) issues 64 32-bit integer add, multiply(-add), shift, compare or
# logic instructions per clock per SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput), on 132 SMs at the clock nvidia-smi
# reports as clocks.max.sm; HBM3 moves 3.35 TB/s. Instruction counts are
# those the function needs at least (not the kernel's own grouping: the
# walk's inversions are one per launch), low where in doubt so the bound
# stays a bound:
INT32_PER_CLK_SM, N_SM, HBM_BYTES_PER_S = 64, 132, 3.35e12
MUL_OPS = 160  # fe_mul: 64 wide multiply-adds, 64 carry adds, 32 for the fold
SQR_OPS = 120  # a squaring: 36 wide multiply-adds, 36 carry adds, 16 to double, the fold
SUB_OPS = 16  # fe_sub / fe_add: 8 subtracts with borrow + the conditional p
# a^-1 by safegcd: 20 batches of 30 divsteps (~12 logic operations each)
# and the batch's matrix applied to d, e, f, g (~150: 72 wide multiply-adds
# and their carries); the addition chain a^(p-2) needs 255 squarings and 15
# products, 3x as many
INV_OPS = 20 * (30 * 12 + 150)
SHA_OPS = 64 * 14 + 48 * 10  # rounds (3 funnel shifts x2, 5 LOP3/IADD3...) + schedule
# 2 lines x 80 steps (LOP3, IADD3, 2 SHF, add, and a second IADD3 where the
# message word is not a constant of the digest's padding) + output; counted
# at 5 a step
RMD_OPS = 160 * 5 + 20
KECCAK_OPS = 24 * 190  # theta 90, rho 48, chi 50, iota 2 (32-bit halves)
HASH_OPS = {"hash160": SHA_OPS + RMD_OPS + 25, "hash160_u": 2 * SHA_OPS + RMD_OPS + 40,
            "keccak": KECCAK_OPS + 16}
MODE_HASHES = {"xpoint": [], "rmd160": ["hash160"] * 2, "eth": ["keccak"],
               "address_u": ["hash160_u"], "rmd160_both": ["hash160"] * 2 + ["hash160_u"]}


def mk_suffix_ops(n_runs):
    """The 5 base-58 digits of a counter (a multiply-high, a shift and a
    multiply-subtract each), the alphabet's runs and the OR into the block."""
    return 20 + 3 * n_runs


def ladder_ops(k_lm):
    """K6's least work for the (8, V) scalars k_lm (numpy uint32): one mixed
    add (8 products, 3 squarings, 6 subtractions) per non-zero byte after a
    lane's first, the batch's 3 products per lane and one inversion, and 3
    products and a squaring to affine."""
    import numpy as np

    nz = (((k_lm[:, None, :] >> (8 * np.arange(4)[None, :, None])) & 0xFF) != 0).sum((0, 1))
    adds = np.maximum(nz.astype(np.int64) - 1, 0).sum()
    V = k_lm.shape[1]
    return (int(adds) * (8 * MUL_OPS + 3 * SQR_OPS + 6 * SUB_OPS)
            + V * (6 * MUL_OPS + SQR_OPS) + INV_OPS)


def walk_point_ops(points):
    """The least work of the affine walk per point, with all `points` of
    a launch in one Montgomery batch: dx (with its zero test), dy, the
    batch's three products per point, lambda, lambda^2, x3, and the
    batch's one inversion shared out."""
    return 2 * (SUB_OPS + 4) + 4 * MUL_OPS + SQR_OPS + 3 * SUB_OPS + INV_OPS / points


def walk_pair_point_ops(points):
    """The least work of the paired walk per point (two points to a pair
    centre +- t_d): half of a pair's dx (with its zero test), its three
    chain products, two lambdas, two squarings and five subtractions (dy
    twice, x_C + x_t, x3 twice), and the batch's one inversion shared out:
    2.5 products and a squaring a point, against walk_point_ops' 4."""
    return (SUB_OPS + 4) / 2 + 2.5 * MUL_OPS + SQR_OPS + 2.5 * SUB_OPS + INV_OPS / points


def k4_ops(mode, n_endo, T, TB, points):
    """K4's 32-bit integer instructions for `points` points: the walk,
    y3 where the mode hashes it, the GLV products, each query's hash,
    byte swaps and T interval compares (5 each) and TB bucket reads (2)."""
    per = walk_point_ops(points)
    if mode in ("eth", "address_u", "rmd160_both"):
        per += MUL_OPS + 2 * SUB_OPS
    per += (n_endo - 1) * MUL_OPS
    for h in MODE_HASHES[mode]:
        per += n_endo * (HASH_OPS[h] + 2 + 5 * T + 2 * TB)
    if mode == "xpoint":
        per += n_endo * (5 * T + 2 * TB)
    return per * points


def walk_prefix_ops(W, U):
    """walk_prefix: per element of the W*(U+2) batch a subtraction, its zero
    test and one prefix product; per walker the advance lane's product."""
    return W * (U + 2) * (SUB_OPS + 4 + MUL_OPS) + W * (MUL_OPS + SUB_OPS)


def walk_emit_ops(W, U, need_y, n_endo):
    """walk_emit: two peel products per element; per table lane and sign
    lambda, lambda^2 and x3 (y3 with need_y), dy; the GLV products of every
    lane; the advance lane's add and doubling."""
    lane = MUL_OPS + SQR_OPS + 2 * SUB_OPS + (MUL_OPS + 2 * SUB_OPS if need_y else 0)
    per_w = 2 * MUL_OPS + 7 * MUL_OPS + 3 * SQR_OPS + 12 * SUB_OPS
    return (2 * W * (U + 2) * MUL_OPS + W * U * (2 * lane + 3 * SUB_OPS)
            + (n_endo - 1) * W * (2 * U + 1) * MUL_OPS + W * per_w)


def k1_ops(T, K):
    """K1's least work: T*K affine adds with y (the denominator with its
    zero test, the numerator, the batch's three products, lambda,
    lambda^2, x3 and y3), all sharing one inversion."""
    return T * K * (2 * (SUB_OPS + 4) + 5 * MUL_OPS + SQR_OPS + 4 * SUB_OPS) + INV_OPS


def k1_bytes(T, K):
    """K1 reads P (T points) and the table (K points) and writes the T*K
    bases, the T next states and T*K flag bytes."""
    return 64 * (T + K) + 64 * T * K + 64 * T + T * K


def k3_ops_bytes(n_kept, bloom2=True):
    """K3: ~60 instructions per kept key (bitmap index, the four fmix32
    mixes, three atomicOr; 10 for the bitmap alone); reads the kept keys'
    qhi and qlo, and each of a kept key's random atomics (three, or one
    into the bitmap alone) reads and writes a 32-byte sector."""
    return (60 if bloom2 else 10) * n_kept, (8 + (3 if bloom2 else 1) * 64) * n_kept


def bound_ms(ops, nbytes, clock_mhz):
    """(least milliseconds, 'operations' or 'bytes')."""
    t_ops = ops / (INT32_PER_CLK_SM * N_SM * clock_mhz * 1e6)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def log(msg):
    print(f"[smoke] {msg}", flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def smi(query):
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "nvidia-smi failed"


def card_line():
    return smi("name,power.limit")


def sm_clock_mhz():
    """clocks.max.sm, the clock the bounds assume."""
    try:
        return float(smi("clocks.max.sm").split()[0])
    except ValueError:
        fail("nvidia-smi gave no SM clock")


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


def device_ms(fn, reps):
    """Mean device milliseconds of fn() over reps back-to-back runs after
    one warm-up run: a sleep kernel holds the stream while the host
    enqueues all reps, so the CUDA events time the card's work alone and
    not the host's launch rate (a small kernel's wrapper takes longer to
    call than the kernel takes to run). The sleep lasts twice the host's
    enqueue time of the reps, at least 50 ms (cycles at 2 GHz, above the
    card's clock, so the sleep is no shorter)."""
    import torch

    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * max(0.05, 2 * reps * host_s)))
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def cold_ms(fn, flush):
    """fn()'s card time with a cold L2: the time of a fill of flush (a 64 MB
    tensor, past the 50 MB L2) and fn, less the fill's alone."""
    both, _ = device_ms(lambda: (flush.zero_(), fn())[1], 50)
    alone, _ = device_ms(flush.zero_, 50)
    return both - alone


def enqueue_ms(fn, reps):
    """Mean host milliseconds to enqueue fn() (its launches, not the card's
    work): the runs are queued behind a sleep kernel, as in device_ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9 * max(0.05, 2 * reps * host_s)))
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = 1000 * (time.perf_counter() - t) / reps
    torch.cuda.synchronize()
    return ms


def device_ops(fn):
    """(kernels, copies and fills that fn() put on the card, the memsets
    among them), counted from torch.profiler's CUDA activity ((0, 0) when
    the profiler saw none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(evs), sum("memset" in e.name.lower() for e in evs)


def device_launches(fn):
    """Kernels, copies and fills that fn() put on the card (device_ops)."""
    return device_ops(fn)[0]


def ptxas_summary(log):
    """One line per function from nvcc -Xptxas -v: registers, stack, spills."""
    regs, props, cur = {}, {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            cur = ln.split("Function properties for")[-1].strip()
        elif "stack frame" in ln and cur:
            props[cur] = ln.strip()
        elif "Compiling entry function" in ln:
            cur = ln.split("'")[1]
        elif "Used" in ln and "registers" in ln and cur:
            regs[cur] = ln.split(":", 1)[1].strip()
    names = list(props)
    res = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                         text=True, timeout=60)
    pretty = res.stdout.splitlines() if res.returncode == 0 else names
    if len(pretty) != len(names):
        pretty = names
    out = []
    for raw, nice in zip(names, pretty):
        nice = nice.replace("(anonymous namespace)::", "").split("(")[0]
        nice = re.sub(r"^void |_INTERNAL_\w+::", "", nice)
        out.append(f"{nice}: {regs.get(raw, 'device function')}; {props[raw]}")
    return out


def ecref_window_sums(ks):
    """k*G for each python int k: the sum of its non-zero byte windows'
    table points gtable[w][b] = b*2^(8w)*G, added in window order by ecref's
    affine law, the lanes of a window sharing one inversion (Montgomery's
    trick); a lane whose sum meets infinity or a doubling takes
    ecref.point_add. Exact, ~6 products a lane a window."""
    from keyhuntm1cpu_tpu_torch.curve.tables import gtable_np
    from keyhuntm1cpu_tpu_torch.field import fe
    from keyhuntm1cpu_tpu_torch.ref import ecref

    P = ecref.P
    tx, ty = ([[fe.limbs_to_int(g[w, b]) for b in range(256)] for w in range(32)]
              for g in gtable_np())
    acc = [None] * len(ks)
    for w in range(32):
        adds, dens = [], []
        for j, k in enumerate(ks):
            b = (k >> (8 * w)) & 0xFF
            if not b:
                continue
            q, a = (tx[w][b], ty[w][b]), acc[j]
            if a is None or a[0] == q[0]:
                acc[j] = ecref.point_add(a, q)
            else:
                adds.append((j, q))
                dens.append((q[0] - a[0]) % P)
        pre, run = [], 1
        for d in dens:
            run = run * d % P
            pre.append(run)
        inv = ecref.inv_mod(run)
        for n in range(len(dens) - 1, -1, -1):
            j, (qx, qy) = adds[n]
            inv_d = inv * pre[n - 1] % P if n else inv
            inv = inv * dens[n] % P
            x1, y1 = acc[j]
            lam = (qy - y1) * inv_d % P
            x3 = (lam * lam - x1 - qx) % P
            acc[j] = (x3, (lam * (x1 - x3) - y1) % P)
    return acc


def ecref_check(ks, x_lm, y_lm, lanes):
    """The lanes (indices) of `lanes` whose affine (x, y) (numpy (8, V)
    uint32 limbs) is not k*G (ks: python ints), by ecref_window_sums."""
    from keyhuntm1cpu_tpu_torch.field import fe

    lanes = list(lanes)
    want = ecref_window_sums([ks[j] for j in lanes])
    return [j for j, pt in zip(lanes, want)
            if pt is None or (fe.limbs_to_int(x_lm[:, j]), fe.limbs_to_int(y_lm[:, j])) != pt]


def max_abs_err(got, want):
    import torch

    err = 0
    for g, w in zip(got, want):
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def marked(eng, name="_chunk_fn"):
    """Wrap an engine's chunk function: a CUDA event pair around each call's
    work on the stream and the host's enqueue time. Returns (marks, enqueue)."""
    import torch

    marks, enqueue = [], []
    fn = getattr(eng, name)

    def wrapped(*a):
        t = time.perf_counter()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = fn(*a)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record()
        marks.append((ev0, ev1))
        enqueue.append(time.perf_counter() - t)
        return out

    setattr(eng, name, wrapped)
    return marks, enqueue


def host_timed(eng, name, log_args=None):
    """Wrap an engine method with a host clock: returns [seconds, calls,
    calls with a non-empty first argument]; log_args collects the first
    arguments."""
    acc = [0.0, 0, 0]
    fn = getattr(eng, name)

    def wrapped(*a):
        t = time.perf_counter()
        out = fn(*a)
        acc[0] += time.perf_counter() - t
        acc[1] += 1
        if a and hasattr(a[0], "__len__"):
            acc[2] += bool(len(a[0]))
            if log_args is not None:
                log_args.extend(a[0])
        return out

    wrapped.__wrapped__ = fn
    setattr(eng, name, wrapped)
    return acc


def phase1_kernels(dev, results, clock):
    import numpy as np
    import torch

    from keyhuntm1cpu_tpu_torch.curve import pwalk, tables
    from keyhuntm1cpu_tpu_torch.engine.bsgs import BUILD_BLOCKS
    from keyhuntm1cpu_tpu_torch.field import fe, pinv
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp
    from keyhuntm1cpu_tpu_torch.ref import ecref

    def limbs(v):
        return torch.from_numpy(fe.int_to_limbs(v).view(np.int32).copy())

    def cols(pts):
        return (torch.stack([limbs(p[0]) for p in pts]).t().contiguous().to(dev),
                torch.stack([limbs(p[1]) for p in pts]).t().contiguous().to(dev))

    import pair_walk_model as pm  # tests/: the paired walk's rare lanes

    stride = 2 * (1 << 28)  # the main path's m
    s_pt = ecref.point_neg(ecref.scalar_mult(stride))  # the search step S
    adv = ecref.point_neg(ecref.scalar_mult(U * stride))  # the search ADV = U*S
    adv_k = (-U * stride) % ecref.N
    walk = pwalk.walk_tables(s_pt, U, adv, K, dev)  # the engine's tables, built once
    ax, ay, tab, ctab = walk.adv_x, walk.adv_y, walk.adv_tab, walk.pair_tab[2:]
    cS = ecref.scalar_mult(pm.centre_scalar(U), s_pt)  # a row's centre is its base + c*S

    def check_k1(ks, adv_pt, ak, got):
        """Every lane of K1's output against ecref: lane s of target t is
        P_t + s*ADV (the next state at s = K; ADV = ak*G); flagged exactly
        where that is the point at infinity. Returns the number of doubling
        lanes and the bases' points, column t*K + s (None at infinity)."""
        bx, by, nx, ny, adeg = (t.cpu().numpy() for t in got[:5])
        T_, K_ = adeg.shape
        n_dbl, rows = 0, []
        for t, k in enumerate(ks):
            pt = ecref.scalar_mult(k)
            for s in range(K_ + 1):
                if s:
                    n_dbl += ((k - s * ak) % ecref.N == 0)  # P == s*ADV
                    pt = ecref.point_add(pt, adv_pt)
                    if bool(adeg[t, s - 1]) != (pt is None):
                        fail(f"K1 flag t={t} s={s - 1} is not the infinity of P + {s}*ADV")
                if s < K_:
                    rows.append(pt)
                if pt is None:
                    continue
                x, y = ((bx[:, t * K_ + s], by[:, t * K_ + s]) if s < K_
                        else (nx[:, t], ny[:, t]))
                if (fe.limbs_to_int(x.view(np.uint32)), fe.limbs_to_int(y.view(np.uint32))) != pt:
                    fail(f"K1 lane t={t} s={s} differs from ecref")
        return n_dbl, rows

    def check_centres(rows, got, c_pt, what):
        """K1's centre lanes (got[5:]: centres and flags) against ecref: row
        r's centre is rows[r] + c*S (c_pt), flagged exactly where rows[r] is
        at infinity or off the curve or the centre is the point at infinity.
        Returns the number of flagged rows."""
        cx, cy, cflag = (t.cpu().numpy() for t in got[5:])
        for r, b in enumerate(rows):
            want = None if b is None or not ecref.is_on_curve(b) else ecref.point_add(b, c_pt)
            if bool(cflag[r]) != (want is None):
                fail(f"K1 centre flag {what} row {r} is {bool(cflag[r])}, ecref's "
                     f"{want is None}")
            if want is not None and (fe.limbs_to_int(cx[:, r].view(np.uint32)),
                                     fe.limbs_to_int(cy[:, r].view(np.uint32))) != want:
                fail(f"K1 centre {what} row {r} differs from ecref")
        return int(cflag.sum())

    # K1 at the main path's shape T=1 (the kernels line), with the paired
    # walk's centre lanes as the BSGS chunk runs it and without them, and
    # planted: a doubling at the middle lane (P == K/2*ADV), the point at
    # infinity in the next state (P == -K*ADV) and row 0's centre at
    # infinity (P == -c*S); at T=16 those and P == ADV (lane 1 doubles) and
    # P == -3*ADV (lane 3 is infinite, its row's centre flagged) side by side
    base_k = [0x1234567890ABCDEF + 99991 * t for t in range(16)]
    c_k = pm.centre_scalar(U) * stride % ecref.N  # c_k*G = -c*S
    plants = [K // 2 * adv_k % ecref.N, -K * adv_k % ecref.N, adv_k, -3 * adv_k % ecref.N, c_k]
    for name, ks in (("T=1", base_k[:1]), ("T=1 P=K/2*ADV", plants[:1]),
                     ("T=1 P=-K*ADV", plants[1:2]), ("T=1 P=-c*S", plants[4:]),
                     ("T=16 planted", plants + base_k[5:])):
        px, py = cols([ecref.scalar_mult(k) for k in ks])
        bases_ms, got = device_ms(lambda: pwalk.advance_chain(px, py, ax, ay, K, tab), 20)
        ms, cgot = device_ms(lambda: pwalk.advance_chain(px, py, ax, ay, K, tab, ctab), 20)
        pms, want = timed(lambda: pwalk.advance_chain_ref(px, py, ax, ay, K, tab, ctab), 1)
        err = max_abs_err(cgot, want) + max_abs_err(got, cgot[:5])
        if err or len(cgot) != 8:
            fail(f"K1 advance_chain {name} differs from its plain version or from K1 without "
                 f"the centre lanes (max_abs_err {err})")
        n_dbl, rows = check_k1(ks, adv, adv_k, got)
        n_cf = check_centres(rows, cgot, cS, name)
        log(f"K1 advance_chain {name} K={K}: bases and centres equal to plain and to ecref on "
            f"every lane ({n_dbl} doubling, {int(got[4].sum())} infinite, {n_cf} centres "
            f"flagged); {ms:.4f} ms with the centre lanes, {bases_ms:.4f} ms without "
            f"(plain {pms:.1f} ms)")
        if name == "T=1":
            k1_ms, k1_bases_ms, k1_plain, k1_err = ms, bases_ms, pms, err
    # the latency floor: one inversion on one thread (pinv at n = 1, the
    # same fe_inv_const) plus the tile's product tree
    one = limbs(3).to(dev)[:, None]
    inv1_ms, _ = device_ms(lambda: pinv.inv_batch(one), 20)
    bms, by_ = bound_ms(k1_ops(1, 2 * K), k1_bytes(1, 2 * K), clock)
    log(f"K1 at T=1 K={K} with the centre lanes: {k1_ms:.4f} ms ({k1_bases_ms:.4f} without); "
        f"least work of its 2K adds {bms:.6f} ms by {by_}; latency floor one inversion on one "
        f"thread ({inv1_ms:.4f} ms, pinv at n = 1) and the tile's product tree; plain "
        f"{k1_plain:.1f} ms")
    results["advance_chain"] = dict(max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain,
                                    bound_ms=bms, bound_by=by_, bases_ms=k1_bases_ms)

    def base_rows(bx, by, rows):
        """The bases (x, y) of columns `rows` as python ints."""
        xs, ys = (t[:, rows].t().contiguous().cpu().numpy().view(np.uint32) for t in (bx, by))
        return [(fe.limbs_to_int(x), fe.limbs_to_int(y)) for x, y in zip(xs, ys)]

    def replant(bx, by, centres, rows, wk, c_pt, what):
        """Plant `rows` ({row: base (x, y), ints}) in K1's bases, and their
        centres and flags from K1 itself: K1 with the centre lanes at K = 1
        over the planted bases as its targets (the centre table c*S), held
        to its plain version and to ecref, written over centres (K1's (x, y,
        flags) of the chunk). Returns the number of planted rows flagged."""
        for r, (x, y) in rows.items():
            bx[:, r], by[:, r] = limbs(x).to(dev), limbs(y).to(dev)
        idx = sorted(rows)
        rx, ry = bx[:, idx].contiguous(), by[:, idx].contiguous()
        a_tab = tuple(t[:, :1].contiguous() for t in wk.adv_tab)
        c_tab = tuple(t[:, :1].contiguous() for t in wk.pair_tab[2:])  # j = 0: c*S
        got = pwalk.advance_chain(rx, ry, wk.adv_x, wk.adv_y, 1, a_tab, c_tab)
        if max_abs_err(got, pwalk.advance_chain_ref(rx, ry, wk.adv_x, wk.adv_y, 1, a_tab,
                                                    c_tab)) or len(got) != 8:
            fail(f"K1's centre lanes over the {what} plants differ from the plain version")
        n = check_centres(base_rows(bx, by, idx), got, c_pt, what)
        for dst, src in zip(centres, got[5:]):
            dst[..., idx] = src
        return n

    def edge_plants(tab_x, tab_y, plants):
        """base row = tab[u] (sign 1) or -tab[u]: dx == 0 at (row, u)"""
        out = {}
        for row, u, sign in plants:
            y = fe.limbs_to_int(tab_y[u])
            out[row] = (fe.limbs_to_int(tab_x[u]), y if sign > 0 else ecref.P - y)
        return out

    def edges(R_, U_):
        return ((0, 0, 1), (1, 127, -1), (R_ // 2, 128, 1), (R_ // 2 + 1, 255, -1),
                (R_ - 2, U_ // 2, 1), (R_ - 1, U_ - 1, -1))

    def rare_plants(R_, S_, tab_x, tab_y, taken):
        """tests/pair_walk_model.py's rare lanes of the paired walk, each
        case's rows moved clear of `taken` (a 32-row group apart where they
        fit): base = +-tab_u at both columns of a pair and at a block's first
        and last pair, a pair with dx == 0 on each side, base = +-c*S (the
        centre at infinity, a doubling centre), bases off the curve, x3
        below 2^32 + 977 and dy == 0."""
        pts = [(fe.limbs_to_int(x), fe.limbs_to_int(y)) for x, y in zip(tab_x, tab_y)]
        out = {}
        for case in ("plus_minus", "pair_dx_zero", "centre", "off_curve", "fe_edges"):
            rows = pm.plants(case, len(pts), pts, S_)
            off = next(o for o in (*range(0, R_, 32), *range(R_))
                       if all(r + o < R_ and r + o not in taken for r in rows))
            for r, b in rows.items():
                out[r + off] = b
                taken.add(r + off)
        return out

    # K2 at R=K=256, U=16384 (T=1) as the BSGS chunk runs it: the paired walk
    # (walk_pairs_kernel) over K1's bases and centres, with planted dx == 0
    # lanes (two inside blocks, the rest at the first and last thread of a
    # block and in the last row), which it walks alone after its loop; held
    # to the plain version over every lane, beside K2 a point a thread
    # (walk_blocks_kernel, which shapes with U % 64 != 0 run) on the same
    # bases
    tab_x, tab_y = tables.step_table(s_pt, U)
    tx, ty = walk.tab_x, walk.tab_y
    px, py = cols([ecref.scalar_mult(0x7CCE5EFDACCF6808 - 12345)])
    bx, by, _, _, _, *centres = pwalk.advance_chain(px, py, ax, ay, K, tab, ctab)
    plants = ((K // 32, U // 164, 1), (K * 25 // 32, U * 5 // 16, -1)) + edges(K, U)
    replant(bx, by, centres, edge_plants(tab_x, tab_y, plants), walk, cS, "edge")
    pairs = (*walk.pair_tab[:2], *centres)
    pms, want = timed(lambda: pwalk.walk_blocks_ref(bx, by, tx, ty), 1)
    ms, got = device_ms(lambda: pwalk.walk_blocks(bx, by, tx, ty, None, pairs), 20)
    point_ms, got1 = device_ms(lambda: pwalk.walk_blocks(bx, by, tx, ty), 20)
    k2_err = max_abs_err(got, want) + max_abs_err(got1, want)
    if k2_err:
        fail("K2 walk_blocks (the paired walk or a point a thread) differs from its plain "
             "version")
    deg = got[2].cpu().numpy()
    if not all(deg[row, u] for row, u, _ in plants):
        fail("K2 planted dx == 0 lanes not flagged")
    log(f"K2 walk_blocks R={K} U={U}: the paired walk equal to plain over every lane, "
        f"dx==0 flagged; {ms:.4f} ms (a point a thread {point_ms:.4f} ms, the same words; "
        f"plain {pms:.1f} ms)")
    nbytes = 64 * (K + U) + 9 * K * U
    bms, by_ = bound_ms(walk_point_ops(K * U) * K * U, nbytes, clock)
    pbms, _ = bound_ms(walk_pair_point_ops(K * U) * K * U, nbytes, clock)
    results["walk_blocks"] = dict(max_abs_err=k2_err, ms=ms, plain_ms=pms, bound_ms=bms,
                                  bound_by=by_, paired_bound_ms=pbms, point_ms=point_ms)
    # K2 with the level-1 probe (the BSGS chunk's form) against a 2^35-bit
    # bitmap of m = 2^28's density: the walk's words bit for bit the plain
    # version's, the survivor mask its plain version's, and its compaction
    # (kh_mask_compact) kh_probe_compact's over the same keys; a point a
    # thread beside it
    g = torch.Generator(device=dev).manual_seed(35)
    words = torch.randint(-2**31, 2**31, (1 << (MAIN_BITS - 5),), dtype=torch.int32,
                          device=dev, generator=g)
    for _ in range(6):
        words &= torch.randint(-2**31, 2**31, words.shape, dtype=torch.int32, device=dev,
                               generator=g)
    bm = bmp.DeviceBitmap(words, MAIN_BITS)
    fms, fused = device_ms(lambda: pwalk.walk_blocks(bx, by, tx, ty, bm, pairs), 20)
    point_fms, fused1 = device_ms(lambda: pwalk.walk_blocks(bx, by, tx, ty, bm), 20)
    qhi, qlo = fused[1].reshape(-1), fused[0].reshape(-1)
    mask_want = bmp.survivor_mask_ref(bm, want[1], want[0])
    cms, stage1 = device_ms(lambda: bmp.mask_compact(fused[3], qhi, qlo, CASCADE_C[0]), 20)
    pcms, stage1_want = device_ms(lambda: bmp.probe_compact(bm, qhi, qlo, CASCADE_C[0]), 20)
    f_err = max_abs_err(fused[:3], want) + max_abs_err([fused[3]], [mask_want])
    f_err += max_abs_err(fused1, fused) + max_abs_err(stage1, stage1_want)
    if f_err or len(fused) != 4:
        fail(f"K2 with the probe differs from the plain version, its mask from the plain "
             f"version's, a point a thread from the paired walk or its compaction from "
             f"kh_probe_compact's (max_abs_err {f_err})")
    log(f"K2 with the level-1 probe R={K} U={U} 2^{MAIN_BITS} bits: the paired walk equal to "
        f"plain, mask to plain, {int(stage1.n)} survivors compacted equal to "
        f"kh_probe_compact's; {fms:.4f} ms against {ms:.4f} alone (a point a thread "
        f"{point_fms:.4f} / {point_ms:.4f}); kh_mask_compact {cms:.4f} ms against "
        f"kh_probe_compact {pcms:.4f} ms")
    n1 = int(stage1.n)
    cpms, _ = timed(lambda: bmp.mask_compact_ref(mask_want, qhi, qlo, CASCADE_C[0]), 1)
    cbms, cby = bound_ms(0, 4 * len(mask_want.reshape(-1)) + 8 * n1 + 12 * CASCADE_C[0] + 4,
                         clock)
    results["walk_blocks"] |= dict(fused_ms=fms, point_fused_ms=point_fms)
    results["mask_compact"] = dict(max_abs_err=f_err, ms=cms, plain_ms=cpms, bound_ms=cbms,
                                   bound_by=cby, probe_compact_ms=pcms)

    def rare_k2(bx, by, centres, wk, S_, tab_x, tab_y, taken, c_pt, bm, what):
        """The paired walk's rare lanes (rare_plants) planted in the bases
        and their centres from K1 (replant): K2 alone and, given bm, with the
        probe, word for word the plain version's. Returns (rows planted,
        centres flagged, dx == 0 lanes)."""
        rows = rare_plants(bx.shape[1], S_, tab_x, tab_y, taken)
        n_cf = replant(bx, by, centres, rows, wk, c_pt, f"{what} rare-lane")
        prs = (*wk.pair_tab[:2], *centres)
        ref = pwalk.walk_blocks_ref(bx, by, wk.tab_x, wk.tab_y, bm)
        err = max_abs_err(pwalk.walk_blocks(bx, by, wk.tab_x, wk.tab_y, None, prs), ref[:3])
        if bm is not None:
            got = pwalk.walk_blocks(bx, by, wk.tab_x, wk.tab_y, bm, prs)
            err += max_abs_err(got, ref) + (len(got) != 4)
        if err:
            fail(f"K2's paired walk at the {what} shape with the rare lanes planted differs "
                 f"from the plain version (max_abs_err {err})")
        return len(rows), n_cf, int(ref[2].sum())

    n_rows, n_cf, n_deg = rare_k2(bx, by, centres, walk, s_pt, tab_x, tab_y,
                                  {r for r, _, _ in plants}, cS, bm, "cell")
    log(f"K2 paired R={K} U={U}: the rare lanes of tests/pair_walk_model.py planted in {n_rows} "
        f"rows ({n_cf} centres flagged by K1, {n_deg} dx == 0 lanes), alone and with the "
        f"probe equal to plain")
    del words, bm, fused, fused1, qhi, qlo, mask_want, stage1, stage1_want, want, got, got1

    # K1 and K2 at the streaming filter build's shape: K = BUILD_BLOCKS,
    # ADV = build_block*G from base 2*build_block*G; R = 128, U = 4096; the
    # paired walk and its rare lanes as at the cell's shape
    badv = ecref.scalar_mult(BUILD_BLOCK)
    bwalk = pwalk.walk_tables(ecref.G, BUILD_BLOCK, badv, BUILD_BLOCKS, dev)
    bax, bay, btab, bctab = bwalk.adv_x, bwalk.adv_y, bwalk.adv_tab, bwalk.pair_tab[2:]
    bcS = ecref.scalar_mult(pm.centre_scalar(BUILD_BLOCK))
    bks = [2 * BUILD_BLOCK, 77 * BUILD_BLOCK, -BUILD_BLOCKS * BUILD_BLOCK % ecref.N]
    px, py = cols([ecref.scalar_mult(k) for k in bks])
    got = pwalk.advance_chain(px, py, bax, bay, BUILD_BLOCKS, btab, bctab)
    err = max_abs_err(got, pwalk.advance_chain_ref(px, py, bax, bay, BUILD_BLOCKS, btab, bctab))
    if err or len(got) != 8:
        fail("K1 at the build shape differs from its plain version")
    n_dbl, rows = check_k1(bks, badv, BUILD_BLOCK, got)
    check_centres(rows, got, bcS, "build")
    ms1, (bx, by, _, _, _, *centres) = device_ms(
        lambda: pwalk.advance_chain(px[:, :1].contiguous(), py[:, :1].contiguous(), bax, bay,
                                    BUILD_BLOCKS, btab, bctab), 20)
    btab_x, btab_y = tables.step_table(ecref.G, BUILD_BLOCK)
    btx, bty = bwalk.tab_x, bwalk.tab_y
    bplants = edges(BUILD_BLOCKS, BUILD_BLOCK)
    replant(bx, by, centres, edge_plants(btab_x, btab_y, bplants), bwalk, bcS, "build edge")
    bpairs = (*bwalk.pair_tab[:2], *centres)
    want = pwalk.walk_blocks_ref(bx, by, btx, bty)
    ms2, got = device_ms(lambda: pwalk.walk_blocks(bx, by, btx, bty, None, bpairs), 20)
    point_ms2, got1 = device_ms(lambda: pwalk.walk_blocks(bx, by, btx, bty), 20)
    if (max_abs_err(got, want) or max_abs_err(got1, want)
            or not all(bool(got[2][r, u]) for r, u, _ in bplants)):
        fail("K2 at the build shape differs from its plain version or misses a dx == 0 lane")
    n_rows, n_cf, n_deg = rare_k2(bx, by, centres, bwalk, ecref.G, btab_x, btab_y,
                                  {r for r, _, _ in bplants}, bcS, None, "build")
    log(f"build shape: K1 T=3 K={BUILD_BLOCKS} bases and centres equal to plain and ecref "
        f"({n_dbl} doubling), K1 at T=1 with the centre lanes {ms1:.4f} ms; K2 "
        f"R={BUILD_BLOCKS} U={BUILD_BLOCK} the paired walk equal to plain, block-edge dx == 0 "
        f"flagged, {ms2:.4f} ms (a point a thread {point_ms2:.4f} ms); the rare lanes in "
        f"{n_rows} rows ({n_cf} centres flagged, {n_deg} dx == 0 lanes) equal to plain")

    # K3 against its plain version and np.bitwise_or.at on 4M random keys
    # (a prefix kept) at each size, with the degeneracy counter (degenerate
    # lanes planted inside and past the prefix) and in its bitmap-only form;
    # timed at the streaming build's step on 2^35-bit filters beside the
    # card's random atomicOr ceiling for the same atomics
    import torch_filter_shapes

    rng = np.random.default_rng(7)
    n = K3_KEYS
    qhi = torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32)).to(dev)
    qlo = torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32)).to(dev)
    n_keep = n - 123457

    def bloom_only(b2bits, both=None):
        """K3's bloom-only form against its plain version and, where given,
        the bloom of the two-filter form."""
        w4, r4 = bmp.empty_filter(b2bits, dev), bmp.empty_filter(b2bits, dev)
        bmp.insert_keys(None, 0, w4, b2bits, qhi, qlo, n_keep)
        bmp.insert_keys_ref(None, 0, r4, b2bits, qhi, qlo, n_keep)
        if not torch.equal(w4, r4) or (both is not None and not torch.equal(w4, both)):
            fail(f"K3 bloom-only form b={b2bits} differs from its plain version or the bloom")
        del w4, r4

    deg = np.zeros(n, bool)
    deg[[0, 31, 32, n_keep - 1, n_keep, n - 1]] = True
    deg[rng.choice(n, 500, replace=False)] = True
    adeg = rng.random(BUILD_BLOCKS) < 0.05
    flags = (torch.from_numpy(deg).to(dev), torch.from_numpy(adeg).to(dev))
    want_bad = int(deg[:n_keep].sum()) + int(adeg.sum())
    kh, kl = bmp.u32(qhi[:n_keep]).cpu(), bmp.u32(qlo[:n_keep]).cpu()
    nb = BUILD_BLOCKS * BUILD_BLOCK  # keys per streaming-build step
    step_flags = (flags[0][:nb], flags[1], torch.zeros((), dtype=torch.int64, device=dev))
    for bits in K3_BITS:
        w1, w2 = bmp.empty_filter(bits, dev), bmp.empty_filter(bits, dev)
        r1, r2 = w1.clone(), w2.clone()
        bad, rbad = (torch.zeros((), dtype=torch.int64, device=dev) for _ in range(2))
        bmp.insert_keys(w1, bits, w2, bits, qhi, qlo, n_keep, *flags, bad)
        bmp.insert_keys_ref(r1, bits, r2, bits, qhi, qlo, n_keep, *flags, rbad)
        if not (torch.equal(w1, r1) and torch.equal(w2, r2)) or int(bad) != int(rbad):
            fail(f"K3 insert_keys b={bits} differs from its plain version")
        if int(bad) != want_bad:
            fail(f"K3 counted {int(bad)} degenerate lanes, planted {want_bad}")
        del r1, r2
        for words, planes in ((w1, bmp.bitmap_bit_planes(kh, kl, bits)),
                              (w2, bmp.bloom2_bit_planes(kh, kl, bits))):
            ref = np.zeros(1 << (bits - 5), np.uint32)
            np.bitwise_or.at(ref, planes[0].numpy(), planes[1].numpy().astype(np.uint32))
            if not np.array_equal(words.cpu().numpy().view(np.uint32), ref):
                fail(f"K3 insert_keys b={bits} differs from np.bitwise_or.at")
            del ref
        # the bitmap alone (a brute target set's form) and the bloom alone (a
        # device table's bloom2)
        w3, r3 = bmp.empty_filter(bits, dev), bmp.empty_filter(bits, dev)
        bmp.insert_keys(w3, bits, None, 0, qhi, qlo, n_keep)
        bmp.insert_keys_ref(r3, bits, None, 0, qhi, qlo, n_keep)
        if not (torch.equal(w3, r3) and torch.equal(w3, w1)):
            fail(f"K3 bitmap-only form b={bits} differs from its plain version or the bitmap")
        del w3, r3
        bloom_only(bits, w2)
        ms, _ = device_ms(lambda: bmp.insert_keys(w1, bits, w2, bits, qhi[:nb], qlo[:nb], nb,
                                                  *step_flags), 20)
        pms, _ = timed(lambda: bmp.insert_keys_ref(w1, bits, w2, bits, qhi[:nb], qlo[:nb], nb,
                                                   *step_flags), 1)
        bms, by_ = bound_ms(*k3_ops_bytes(nb), clock)
        if bits == MAIN_BITS:
            ceil = torch_filter_shapes.rmw_ceiling(w2, bits_list=(bits,), ns=(3 * nb,),
                                                   log=lambda m: None)
            ceil_ms = min(next(iter(ceil.values())).values())
        results["insert_keys"] = dict(max_abs_err=0, ms=ms, plain_ms=pms,
                                      bound_ms=bms, bound_by=by_)
        del w1, w2
        torch.cuda.empty_cache()
    results["insert_keys"]["ceiling_ms"] = ceil_ms
    bloom_only(32)  # a device table's bloom2 at m >= 2^28 (bitmap.bloom2_bits_log2)
    log(f"K3 insert_keys {n} keys ({n_keep} kept) at b={K3_BITS}: equal to plain and to "
        f"np.bitwise_or.at, {want_bad} planted degenerate flags counted, the bitmap-only "
        f"and bloom-only forms equal (bloom-only also at b=32); at b={K3_BITS[-1]} {results['insert_keys']['ms']:.4f} ms per {nb} "
        f"keys (plain {results['insert_keys']['plain_ms']:.1f} ms, bound "
        f"{results['insert_keys']['bound_ms']:.4f} ms by {results['insert_keys']['bound_by']}, "
        f"the card's random atomicOr ceiling for {3 * nb} atomics {ceil_ms:.4f} ms)")
    torch.cuda.synchronize()


def brute_artifact(mode, pt):
    """The target bytes a mode compares for point pt (ref/hashref)."""
    from keyhuntm1cpu_tpu_torch.ref import hashref

    if mode == "xpoint":
        return pt[0].to_bytes(32, "big")
    if mode == "eth":
        return hashref.pubkey_to_eth_address(pt)
    return hashref.pubkey_to_hash160(pt, compressed=mode == "rmd160")


def cmp64(mode, raw):
    return (int.from_bytes(raw, "big") & ((1 << 64) - 1) if mode == "xpoint"
            else int.from_bytes(raw[:8], "big"))


def phase1_brute(dev, results, clock):
    """K4 against its plain version at the main path's K = 256, U = 16384:
    every mode, the endomorphism, and a bucketed T = 4096 set, with
    planted hits and two dx == 0 lanes. rmd160 with T = 32 intervals
    gives the JSON line's numbers. Then the chunk's compaction and summary
    (kh_compact_hits) against its plain version at C = 1024 on those hit
    words and on planted ones."""
    import numpy as np
    import torch

    from keyhuntm1cpu_tpu_torch.curve import pbrute, pwalk, tables
    from keyhuntm1cpu_tpu_torch.engine.brute import BruteParams
    from keyhuntm1cpu_tpu_torch.field import fe
    from keyhuntm1cpu_tpu_torch.ref import ecref

    def limbs(v):
        return torch.from_numpy(fe.int_to_limbs(v).view(np.int32).copy()).to(dev)

    def as_i32(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)

    tab_x, tab_y = tables.step_table(ecref.G, U)
    tx, ty = pwalk.table_to_limb_major(tab_x, dev), pwalk.table_to_limb_major(tab_y, dev)
    adv = ecref.scalar_mult(U)
    b0 = BRUTE_RANGE[0] - 1  # base scalar of step 0: key(s, u) = b0 + s*U + u + 1
    base = ecref.scalar_mult(b0)
    rng = np.random.default_rng(11)
    empty = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    bx, by, _, _, _ = pwalk.advance_chain(limbs(base[0])[:, None], limbs(base[1])[:, None],
                                          limbs(adv[0]), limbs(adv[1]), K)
    # bases 3 and 9: tab[u] and -tab[u]: dx == 0 at those lanes
    planted_deg = ((3, U // 7), (9, U - 2))
    for row, u in planted_deg:
        y = fe.limbs_to_int(tab_y[u])
        bx[:, row] = limbs(fe.limbs_to_int(tab_x[u]))
        by[:, row] = limbs(y if row == 3 else ecref.P - y)
    cases = ([(m, 1, 32, False) for m in pbrute.MODES]
             + [("rmd160", 3, 32, False), ("xpoint", 3, 32, False),
                ("rmd160", 1, 4096, True)])
    err_all = 0
    for mode, n_endo, T, bucketed in cases:
        hits = [(0, 5), (K - 1, U - 1), (K // 2, U // 3 + 1)]
        pts = [ecref.scalar_mult(b0 + s * U + u + 1) for s, u in hits]
        if mode == "rmd160":
            pts[1] = ecref.point_neg(pts[1])  # the other parity
        vals = [cmp64(mode, brute_artifact(mode, pt)) for pt in pts]
        if n_endo == 3:  # lambda * key(2, 77) shows as query set e = 1
            vals.append(cmp64(mode, brute_artifact(
                mode, ecref.scalar_mult(ecref.LAMBDA * (b0 + 2 * U + 78) % ecref.N))))
        vals += [int(v) for v in rng.integers(0, 2**63, T - len(vals))]
        if bucketed:
            tgt = as_i32(pbrute.pack_intervals([1], [0]))
            btab = as_i32(pbrute.pack_buckets(vals))
            tb = btab.shape[0]
        else:
            tgt, btab, tb = as_i32(pbrute.pack_intervals(vals, vals)), empty, 0
        args = (bx, by, tx, ty, tgt, btab, mode, n_endo, tb)
        ms, got = device_ms(lambda: pbrute.brute_walk_blocks(*args), 5)
        pms, want = timed(lambda: pbrute.brute_walk_blocks_ref(*args), 1)
        err = max_abs_err([got], [want])
        err_all = max(err_all, err)
        name = f"{mode} n_endo={n_endo} T={T}{' bucketed' if bucketed else ''} K={K}"
        if err:
            fail(f"K4 {name} differs from its plain version (max_abs_err {err})")
        g = got.cpu().numpy()
        n_hit = sum(int(g[s, u] != 0) for s, u in hits)
        if n_hit != 3 or (n_endo == 3 and not g[2, 77] >> pbrute.n_qsets(mode, 1)):
            fail(f"K4 {name}: planted hits missing")
        if not all(g[row, u] == pbrute.HIT_DEGENERATE for row, u in planted_deg):
            fail(f"K4 {name}: planted dx == 0 lanes not flagged")
        ops = k4_ops(mode, n_endo, 8 if bucketed else T, tb, K * U)
        nbytes = 64 * (K + U) + 16 * tgt.shape[1] + 512 * tb + 4 * K * U
        bms, by_ = bound_ms(ops, nbytes, clock)
        log(f"K4 brute_walk_blocks {name}: equal to plain, hits and dx==0 lanes "
            f"flagged; {ms:.3f} ms (plain {pms:.1f} ms, bound {bms:.3f} ms by {by_})")
        if (mode, n_endo, bucketed) == ("rmd160", 1, False):
            results["brute_walk_blocks"] = dict(ms=ms, plain_ms=pms, bound_ms=bms,
                                                bound_by=by_)
            k4_hits = got
        del got, want

    # K4 with real intervals (lo < hi): bench_vanity's 9 intervals of key
    # 777's prefix beside the three planted hits as point intervals; every
    # hit word past the planted ones must be a hash inside an interval
    from keyhuntm1cpu_tpu_torch.engine.vanity import vanity_intervals
    from keyhuntm1cpu_tpu_torch.ref import hashref

    prefix = hashref.pubkey_to_address(ecref.scalar_mult(777))[:5]
    ivs = [(int.from_bytes(lo[:8], "big"), int.from_bytes(hi[:8], "big"))
           for lo, hi in vanity_intervals(prefix)]
    hits = [(0, 5), (K - 1, U - 1), (K // 2, U // 3 + 1)]
    pts = [ecref.scalar_mult(b0 + s * U + u + 1) for s, u in hits]
    pts[1] = ecref.point_neg(pts[1])
    vals = [cmp64("rmd160", brute_artifact("rmd160", pt)) for pt in pts]
    tgt = as_i32(pbrute.pack_intervals(vals + [lo for lo, _ in ivs], vals + [hi for _, hi in ivs]))
    args = (bx, by, tx, ty, tgt, empty, "rmd160", 1, 0)
    ms, got = device_ms(lambda: pbrute.brute_walk_blocks(*args), 5)
    pms, want = timed(lambda: pbrute.brute_walk_blocks_ref(*args), 1)
    err = max_abs_err([got], [want])
    err_all = max(err_all, err)
    name = f"rmd160 with {len(ivs)} intervals of prefix {prefix} and 3 points (T={tgt.shape[1]})"
    if err:
        fail(f"K4 {name} differs from its plain version (max_abs_err {err})")
    g = got.cpu().numpy()
    if not all(g[s, u] for s, u in hits):
        fail(f"K4 {name}: planted hits missing")
    extra = [(int(s), int(u)) for s, u in zip(*np.nonzero((g > 0) & (g < pbrute.HIT_DEGENERATE)))
             if (s, u) not in hits]
    # the base keys of the rows: b0 + s*U, but tab[U // 7] and -tab[U - 2] in
    # the planted dx == 0 rows 3 and 9
    base_key = {3: U // 7 + 1, 9: -(U - 1)}
    for s, u in extra:  # each an interval hit of the parity its bit names
        pt = ecref.scalar_mult((base_key.get(s, b0 + s * U) + u + 1) % ecref.N)
        for q in range(2):
            if g[s, u] >> q & 1:
                par = pt if (pt[1] & 1) == q else ecref.point_neg(pt)
                v = cmp64("rmd160", hashref.pubkey_to_hash160(par))
                if not any(lo <= v <= hi for lo, hi in ivs):
                    fail(f"K4 {name}: lane ({s}, {u}) parity {q} is no interval hit")
    bms, by_ = bound_ms(k4_ops("rmd160", 1, tgt.shape[1], 0, K * U),
                        64 * (K + U) + 16 * tgt.shape[1] + 4 * K * U, clock)
    results["brute_walk_blocks"] |= dict(vanity_ms=ms, vanity_bound_ms=bms)
    log(f"K4 brute_walk_blocks {name} K={K}: equal to plain, {len(extra)} interval hits "
        f"besides the planted ones, each checked on the host; {ms:.3f} ms (plain {pms:.1f} ms, "
        f"bound {bms:.3f} ms by {by_})")
    del got, want
    results["brute_walk_blocks"]["max_abs_err"] = err_all

    # the compaction: K4's rmd160 hit words (3 hits, 2 degenerate lanes) and
    # planted words: R + 1 flagged rows (the overflow), R rows holding more
    # than C words, a dense row beside degenerate words in the first, a
    # middle and the last step; advance flags at steps 0, 77 and K - 1
    C = BruteParams().chunk_cand
    R, nr = pbrute.row_budget(C), K * U // pbrute.LANES
    adeg = torch.zeros(K, dtype=torch.bool, device=dev)
    adeg[[0, 77, K - 1]] = True
    planted = {}
    for name, n_rows, per_row in (("R + 1 rows", R + 1, 2),
                                  ("R rows, more than C words", R, C // R + 3)):
        h = np.zeros((nr, pbrute.LANES), np.uint32)
        for r in np.sort(rng.choice(nr, n_rows, replace=False)):
            h[r, rng.choice(pbrute.LANES, per_row, replace=False)] = rng.integers(1, 512, per_row)
        planted[name] = h
    h = np.zeros((nr, pbrute.LANES), np.uint32)
    h[int(rng.integers(nr))] = rng.integers(1, 1 << 30, pbrute.LANES)
    h = h.reshape(K, U)
    h[0, [0, U // 2]] = h[K // 2, 5] = h[K - 1, U - 1] = pbrute.HIT_DEGENERATE
    h[K // 2, 6] = pbrute.HIT_DEGENERATE | 3
    planted["a dense row, degenerate words"] = h
    cases = {"K4 rmd160 hits": k4_hits} | {k: as_i32(v).reshape(K, U)
                                          for k, v in planted.items()}
    err = 0
    for name, h in cases.items():
        want = pbrute.compact_hits_ref(h, adeg, C)
        # three launches in a row: each on the scratch the one before zeroed
        got = [pbrute.compact_hits(h, adeg, C) for _ in range(3)]
        err = max(err, max_abs_err(got, [want] * 3))
        if err:
            fail(f"kh_compact_hits on {name} differs from its plain version "
                 f"(max_abs_err {err})")
        n = int(want[-1])
        if name == "K4 rmd160 hits" and (n != 3 or int(want[2 * C + 3]) != 1):
            fail(f"compact_hits_ref on K4's hit words: n = {n}, want the 3 planted hits")
        if (name == "R + 1 rows") != (n == C + 1):
            fail(f"compact_hits_ref on {name}: n = {n}")
    ms, _ = device_ms(lambda: pbrute.compact_hits(k4_hits, adeg, C), 20)
    pms, _ = timed(lambda: pbrute.compact_hits_ref(k4_hits, adeg, C), 5)
    ops, memsets = device_ops(lambda: pbrute.compact_hits(k4_hits, adeg, C))
    bms, by_ = bound_ms(0, 4 * K * U + K + 4 * (2 * C + 3 * K + 1), clock)
    results["compact_hits"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by_,
                                   max_abs_err=err)
    log(f"kh_compact_hits K={K} U={U} C={C} (R={R}): equal to compact_hits_ref on "
        f"{', '.join(cases)}, three launches in a row each; {ms:.4f} ms on K4's hit words "
        f"(plain {pms:.3f} ms, bound {bms:.4f} ms by {by_}); "
        f"{ops or 'not measured: the profiler saw no'} device operations a call "
        f"({memsets} memsets)")
    torch.cuda.synchronize()


def minikey_bases(eng, alphabet, counter):
    """(low, prefix17, w22, w23) of the chunk at `counter` (engine/minikeys.py)."""
    from keyhuntm1cpu_tpu_torch.engine import minikeys as mk

    high, low = divmod(counter, mk.LOW_SPAN)
    prefix17 = MK_PREFIX + mk._b58_digits(high, 5, alphabet)
    return (low, prefix17) + eng._base_words(prefix17)


def phase1_minikeys(dev, results, clock):
    """K5 at B = 2^23 over every lane (canonical and custom alphabet), the
    key derivation, K6, K7 and K8 at V = 34,816, against their plain
    versions; K5 and the keys against hashlib on samples, K6 with edge
    scalars planted and a sample against ecref."""
    import hashlib

    import numpy as np
    import torch

    from keyhuntm1cpu_tpu_torch.curve import pladder
    from keyhuntm1cpu_tpu_torch.engine import minikeys as mk
    from keyhuntm1cpu_tpu_torch.field import fe
    from keyhuntm1cpu_tpu_torch.hash import phash, pminikey
    from keyhuntm1cpu_tpu_torch.ref import ecref
    from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet

    B, V = MK_BATCH, mk.valid_budget(MK_BATCH)
    ts = TargetSet(kind="hash160", raw=[b"\x01" * 20], labels=["t"])
    rng = np.random.default_rng(23)
    for alphabet in (mk._B58, MK_CUSTOM):
        eng = mk.MinikeyEngine(ts, prefix=MK_PREFIX, params=mk.tuned_params(batch=B),
                               alphabet=alphabet, device=dev)
        low, prefix17, w22, w23 = minikey_bases(eng, alphabet, MK_COUNTER)
        ms, valid = device_ms(lambda: pminikey.minikey_valid(low, w23, B, alphabet), 10)
        pms, want = timed(lambda: pminikey.minikey_valid_ref(low, w23, B, alphabet), 1)
        err = max_abs_err([valid], [want])
        if err:
            fail(f"K5 minikey_valid ({alphabet[:4]}...) differs from its plain version")
        got = valid.cpu().numpy()
        lanes = np.concatenate([rng.choice(B, min(B, 20000), replace=False),
                                np.nonzero(got)[0][:200]])
        for lane in lanes:
            s_ = prefix17 + mk._b58_digits(low + int(lane), 5, alphabet)
            if (hashlib.sha256((s_ + "?").encode()).digest()[0] == 0) != bool(got[lane]):
                fail(f"K5 lane {lane} differs from hashlib")
        n_valid = int(got.sum())
        if abs(n_valid - B / 256) > 6 * (B / 256) ** 0.5:
            fail(f"K5 found {n_valid} valid lanes of {B}, expected ~{B // 256}")
        runs = len(pminikey.b58_runs(alphabet))
        bms, by_ = bound_ms(B * (mk_suffix_ops(runs) + SHA_OPS), 64 + B, clock)
        log(f"K5 minikey_valid B={B} ({runs} alphabet runs): equal to plain over every "
            f"lane, {n_valid} valid, {len(lanes)} lanes equal to hashlib; {ms:.3f} ms "
            f"(plain {pms:.1f} ms, bound {bms:.3f} ms by {by_})")
        if alphabet == mk._B58:
            results["minikey_valid"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                            bound_ms=bms, bound_by=by_)
            canon = (eng, low, prefix17, w22, valid)
    eng, low, prefix17, w22, valid = canon

    # the compaction and keys: K5's mask, then planted masks: none valid,
    # more valid lanes than V, lanes on both sides of every tile edge, and
    # B not a multiple of the tile
    def check_ck(mask, V_, name):
        got = pminikey.compact_keys(mask, V_, low, w22, mask.shape[0], mk._B58)
        want = pminikey.compact_keys_ref(mask, V_, low, w22, mask.shape[0], mk._B58)
        err = max_abs_err(got, want)
        if err:
            fail(f"compact_keys ({name}) differs from its plain version")
        return got

    ms, (n_valid, vidx, k) = device_ms(
        lambda: pminikey.compact_keys(valid, V, low, w22, B, mk._B58), 10)
    pms, want = timed(lambda: pminikey.compact_keys_ref(valid, V, low, w22, B, mk._B58), 1)
    err = max_abs_err((n_valid, vidx, k), want)
    if err or int(n_valid) != int(valid.sum()):
        fail("compact_keys differs from its plain version")
    vi, kn = vidx.cpu().numpy(), k.cpu().numpy().view(np.uint32)
    for j in list(range(0, V, V // 40)) + [V - 1]:
        s_ = prefix17 + mk._b58_digits(low + min(int(vi[j]), B - 1), 5)
        if fe.limbs_to_int(kn[:, j]) != int.from_bytes(hashlib.sha256(s_.encode()).digest(), "big"):
            fail(f"compact_keys lane {j} differs from hashlib")
    tile = pminikey._tile()
    edges = valid.clone()
    for e in range(tile, B, tile):
        edges[e - 1:e + 1] = True
    cases = {"none valid": (torch.zeros_like(valid), V),
             "n_valid > V": (valid, int(n_valid) // 2),
             "tile edges": (edges, V),
             "B not a multiple of the tile": (valid[:B - tile // 2 - 77], V)}
    for name, (mask, V_) in cases.items():
        got = check_ck(mask, V_, name)
        if int(got[0]) != int(mask.sum()):
            fail(f"compact_keys ({name}) counted {int(got[0])} valid lanes")
    bms, by_ = bound_ms(V * (mk_suffix_ops(6) + SHA_OPS), B + 64 + 4 + 36 * V, clock)
    results["minikey_compact_keys"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                                           bound_by=by_)
    log(f"minikey compact_keys B={B} V={V} ({int(n_valid)} valid, tile {tile}): equal to "
        f"plain and to hashlib on a sample, and to plain with {', '.join(cases)}; {ms:.4f} ms "
        f"(plain {pms:.1f} ms, bound {bms:.4f} ms by {by_})")

    # K6 on those keys with the edge scalars planted in the first columns
    edges = [0, 1, 2, ecref.N - 1, ecref.N, 2 ** 256 - 1,
             0x00FF00000000FF000000000000AB0000000000CD0000000000000000000100]
    for j, e in enumerate(edges):
        k[:, j] = torch.from_numpy(fe.int_to_limbs(e).view(np.int32)).to(dev)
    gx, gy = eng._gx, eng._gy
    ms, pt = device_ms(lambda: pladder.scalar_mult_tiles(k, gx, gy), 10)
    pms, want = timed(lambda: pladder.scalar_mult_split_ref(k, gx, gy, pladder.SPLIT), 1)
    if not all(torch.equal(g, w) for g, w in zip(pt, want)):
        fail("K6 scalar_mult differs from scalar_mult_split_ref on x, y, inf or irr")
    err = max_abs_err(pt, want)
    x, y, inf, irr = (t.cpu().numpy() for t in pt)
    if not (inf[0] and irr[4]) or inf[1:].any() or irr.sum() != 1:
        fail(f"K6 flags wrong: inf {np.nonzero(inf)[0][:5]}, irr {np.nonzero(irr)[0][:5]}")
    kn = k.cpu().numpy().view(np.uint32)
    ks = [fe.limbs_to_int(kn[:, j]) for j in range(V)]
    t0 = time.time()
    unflagged = [j for j in range(1, V) if not irr[j]]
    bad = ecref_check(ks, x.view(np.uint32), y.view(np.uint32), unflagged)
    if bad:
        fail(f"K6 lanes {bad[:5]} ({len(bad)} of {len(unflagged)} unflagged) differ from ecref")
    t_check = time.time() - t0
    for j in [1, 2, 3, 5, 6] + list(range(7, V, V // 30)):
        if irr[j]:
            continue
        want_pt = ecref.scalar_mult(ks[j] % ecref.N)
        if (fe.limbs_to_int(x[:, j].view(np.uint32)),
                fe.limbs_to_int(y[:, j].view(np.uint32))) != want_pt:
            fail(f"K6 lane {j} differs from ecref.scalar_mult")
    bms, by_ = bound_ms(ladder_ops(kn), 2 * 32 * 256 * 32 + 32 * V + 66 * V, clock)
    results["scalar_mult"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                                  bound_by=by_)
    log(f"K6 scalar_mult V={V} (split {pladder.SPLIT}): equal to scalar_mult_split_ref on "
        f"x, y, inf and irr, k=0 infinite, k=N the one irregular lane, every one of the "
        f"{len(unflagged)} unflagged "
        f"lanes equal to ecref ({t_check:.1f} s) and a sample to ecref.scalar_mult; "
        f"{ms:.3f} ms (plain {pms:.1f} ms, bound {bms:.3f} ms by {by_})")

    px, py = pt[0], pt[1]
    for name, fn, ref, ops, nbytes in (
            ("hash160_x2", lambda: phash.hash160_x2_from_batch(px),
             lambda: phash.hash160_x2_ref(px), 2 * HASH_OPS["hash160"], 48),
            ("hash160_u", lambda: phash.hash160_u_from_batch(px, py),
             lambda: phash.hash160_u_ref(px, py), HASH_OPS["hash160_u"], 72)):
        ms, got = device_ms(fn, 10)
        pms, want = timed(ref, 1)
        flat = lambda o: [t for pair in o for t in pair] if name == "hash160_x2" else list(o)
        err = max_abs_err(flat(got), flat(want))
        if err:
            fail(f"{name} differs from its plain version")
        bms, by_ = bound_ms(V * ops, V * nbytes, clock)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by_)
        log(f"{'K7' if name == 'hash160_x2' else 'K8'} {name} V={V}: equal to plain; "
            f"{ms:.3f} ms (plain {pms:.1f} ms, bound {bms:.3f} ms by {by_})")
    torch.cuda.synchronize()


def walker_lookup_inputs(qhi, qlo, deg, adeg, rng, cmax=256, n_surv=200, m=WK_T):
    """lookup_summary's arguments at the walker step's shape from the
    step's queries qhi, qlo (total,) int32 and flags deg (W, U), adeg (W,)
    on the card: cmax survivor slots (n_surv survivors at ascending random
    positions, then padding with the last one's key), a sorted table of m
    keys (random payloads) holding the keys of every 4th survivor, one of
    them twice, and of walker 2's lanes +9, -9 and its center in each query
    set (walker 2 at 9*stride makes the first two degenerate). Returns
    (arguments, the live hits the row must show)."""
    import numpy as np
    import torch

    from keyhuntm1cpu_tpu_torch.filter import sorted_table as st

    dev = qhi.device
    W, U = deg.shape
    npts = 2 * U + 1
    total = qhi.shape[0]
    sets = total // (W * npts)
    flagged = np.array([q * W * npts + 2 * npts + lane for q in range(sets)
                        for lane in (8, U + 8, 2 * U)])
    rest = rng.choice(np.setdiff1d(np.arange(total), flagged), n_surv - len(flagged),
                      replace=False)
    pos = np.sort(np.concatenate([flagged, rest]))
    qh, ql = qhi.cpu().numpy().view(np.uint32), qlo.cpu().numpy().view(np.uint32)
    hits = np.unique(np.concatenate([pos[::4], flagged]))
    rnd = lambda k: rng.integers(0, 2**32, k, dtype=np.uint64).astype(np.uint32)
    fill = m - len(hits) - 1
    table = st.build_sorted_table(np.concatenate([qh[hits], qh[pos[4:5]], rnd(fill)]),
                                  np.concatenate([ql[hits], ql[pos[4:5]], rnd(fill)]), rnd(m),
                                  dev)
    src = torch.from_numpy(np.append(pos, [pos[-1]] * (cmax - len(pos)))).to(dev)
    lpos = torch.where(torch.arange(cmax, device=dev) < len(pos), src, total).to(torch.int32)
    deg_np = deg.cpu().numpy()
    lane = hits % (W * npts) % npts
    dead = (lane < 2 * U) & deg_np[hits % (W * npts) // npts, lane % U]
    args = (table, lpos, qhi[src].contiguous(), qlo[src].contiguous(),
            torch.tensor(len(pos), dtype=torch.int32, device=dev), deg, adeg, total)
    return args, int((~dead).sum())


def phase1_walker(dev, results, clock):
    """The walker path's kernels at its main-path shapes (W = 8, U = 4096,
    chain_len = 32) against their plain versions: walk_prefix and walk_emit
    with C == ADV, C == -ADV and a dx == 0 lane, pinv on the step's chain
    totals with zeros planted, Keccak ETH, K7 and K8 on the step's points
    (the probe's entry in the kernels line comes from phase 3), the probe on
    the step's rmd160 queries against a 2^34-bit bitmap of 2^22 keys (and
    words[idx] beside it), and in bloom2 form on phase 3's C1 queries
    against a 2^35-bit bloom2."""
    import numpy as np
    import torch

    from keyhuntm1cpu_tpu_torch.curve import pwalk, tables, walk
    from keyhuntm1cpu_tpu_torch.curve.points import point_batch_from_ints
    from keyhuntm1cpu_tpu_torch.field import fe, pinv
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp
    from keyhuntm1cpu_tpu_torch.filter import sorted_table as st
    from keyhuntm1cpu_tpu_torch.hash import phash
    from keyhuntm1cpu_tpu_torch.ref import ecref, hashref

    W, U, L = WK_W, WK_U, WK_L
    npts = 2 * U + 1

    def limbs(v):
        return torch.from_numpy(fe.int_to_limbs(v).view(np.int32).copy()).to(dev)

    tab_x, tab_y = tables.step_table(ecref.G, U)
    adv = ecref.scalar_mult(npts)
    rng = np.random.default_rng(41)
    # C == ADV (doubling), C == -ADV (flagged), C == 9G (dx == 0 at u = 9)
    keys = [npts, ecref.N - npts, 9] + [int(k) for k in rng.integers(2**40, 2**50, W - 3)]
    c = point_batch_from_ints([ecref.scalar_mult(k) for k in keys], dev)
    args = (c.x, c.y, pwalk.table_to_limb_major(tab_x, dev),
            pwalk.table_to_limb_major(tab_y, dev), limbs(adv[0]), limbs(adv[1]))
    D = W * (U + 2)
    C = walk.n_chains(W, U, L)

    ms, (pre, tot) = device_ms(lambda: walk.walk_prefix(*args, L), 20)
    pms, want = timed(lambda: walk.walk_prefix_ref(*args, L), 1)
    err = max_abs_err([pre, tot], want)
    if err:
        fail(f"walk_prefix differs from its plain version (max_abs_err {err})")
    bms, by_ = bound_ms(walk_prefix_ops(W, U), 32 * (W + U + 1) + 32 * (L * C + C), clock)
    results["walk_prefix"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                                  bound_by=by_)
    log(f"walk_prefix W={W} U={U} L={L} ({C} chains): equal to plain; {ms:.4f} ms "
        f"(plain {pms:.1f} ms, bound {bms:.4f} ms by {by_})")

    tz = tot.clone()
    tz[:, 0] = 0
    tz[:, C // 2] = 0
    ms, got = device_ms(lambda: pinv.inv_batch(tz), 20)
    pms, want = timed(lambda: pinv.inv_batch_ref(tz), 1)
    err = max_abs_err([got], [want])
    g = got.cpu().numpy().view(np.uint32)
    z = tz.cpu().numpy().view(np.uint32)
    if err or g[:, 0].any() or g[:, C // 2].any():
        fail(f"pinv differs from its plain version or maps 0 to non-zero (max_abs_err {err})")
    for j in set(range(C)) - {0, C // 2}:
        if fe.limbs_to_int(g[:, j]) * fe.limbs_to_int(z[:, j]) % fe.P_INT != 1:
            fail(f"pinv column {j} is no inverse")
    bms, by_ = bound_ms(C * INV_OPS, 64 * C, clock)
    results["inv_batch"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                                bound_by=by_)
    log(f"pinv inv_batch n={C} (two zeros): equal to plain, 0 -> 0, every other column an "
        f"inverse; {ms:.4f} ms (plain {pms:.1f} ms, bound {bms:.4f} ms by {by_})")
    # the four designs of scripts/torch_pinv_shapes.py at this width
    import torch_pinv_shapes

    designs = torch_pinv_shapes.pinv_designs(dev, ns=(C,), log=lambda m: None)
    log(f"pinv designs at n={C} (scripts/torch_pinv_shapes.py, each equal to inv_batch_ref): "
        + ", ".join(f"{k} {v[C]:.4f} ms" for k, v in designs.items()))

    inv_tot = pinv.inv_batch(tot)
    ms, out = device_ms(lambda: walk.walk_emit(*args, pre, inv_tot, L, 1, True), 20)
    pms, want = timed(lambda: walk.walk_emit_ref(*args, pre, inv_tot, L, 1, True), 1)
    err = max_abs_err(out, want)
    if err:
        fail(f"walk_emit differs from its plain version (max_abs_err {err})")
    x_all, y_all, deg, nx, ny, adeg = out
    if adeg.tolist() != [False, True] + [False] * (W - 2) or not bool(deg[2, 8]):
        fail(f"walk_emit flags wrong: adv {adeg.tolist()}, deg {deg.nonzero().tolist()[:4]}")
    xs = x_all[0].cpu().numpy().view(np.uint32)
    for w in (0, 3, W - 1):
        for lane, k in ((0, keys[w] + 1), (U + 7, keys[w] - 8), (npts - 1, keys[w])):
            if fe.limbs_to_int(xs[:, w, lane]) != ecref.scalar_mult(k)[0]:
                fail(f"walk_emit walker {w} lane {lane} differs from ecref")
    if fe.limbs_to_int(nx[:, 0].cpu().numpy().view(np.uint32)) != ecref.scalar_mult(2 * npts)[0]:
        fail("walk_emit's doubling lane (C == ADV) differs from ecref")
    nbytes = 32 * (L * C + C + 2 * U + 2 * W) + 2 * 32 * W * npts + W * U + 65 * W
    bms, by_ = bound_ms(walk_emit_ops(W, U, True, 1), nbytes, clock)
    results["walk_emit"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                                bound_by=by_)
    log(f"walk_emit W={W} U={U} need_y: equal to plain; C == ADV doubled, C == -ADV and "
        f"dx == 0 flagged, lanes equal to ecref; {ms:.4f} ms (plain {pms:.1f} ms, bound "
        f"{bms:.4f} ms by {by_})")
    # an odd chain length: a warp per chain takes a full segment of 32 and a
    # segment of one
    L2 = 33
    pre2, tot2 = walk.walk_prefix(*args, L2)
    if max_abs_err([pre2, tot2], walk.walk_prefix_ref(*args, L2)):
        fail(f"walk_prefix differs from its plain version at L={L2}")
    inv2 = pinv.inv_batch(tot2)
    ms2, out2 = device_ms(lambda: walk.walk_emit(*args, pre2, inv2, L2, 1, True), 20)
    err2 = max_abs_err(out2, walk.walk_emit_ref(*args, pre2, inv2, L2, 1, True))
    if err2:
        fail(f"walk_emit differs from its plain version at L={L2} (max_abs_err {err2})")
    log(f"walk_emit W={W} U={U} L={L2} ({walk.n_chains(W, U, L2)} chains) need_y: equal to "
        f"plain; {ms2:.4f} ms")
    # walk_prefix (a warp per chain, segments of 32 from the bottom) at the
    # other chain lengths of the CUDA tests
    for L3 in (7, 64, 65):
        if max_abs_err(walk.walk_prefix(*args, L3), walk.walk_prefix_ref(*args, L3)):
            fail(f"walk_prefix differs from its plain version at L={L3}")
    log(f"walk_prefix W={W} U={U}: equal to plain at L = 7, 32, 33, 64, 65")

    x, y = x_all[0].reshape(8, -1), y_all.reshape(8, -1)  # the step's 65,544 points
    n = x.shape[1]
    ms, got = device_ms(lambda: phash.keccak_eth_from_batch(x, y), 20)
    pms, want = timed(lambda: phash.keccak_eth_ref(x, y), 1)
    err = max_abs_err(got, want)
    if err:
        fail("keccak_eth differs from its plain version")
    lo, hi = (t.cpu().numpy().view(np.uint32) for t in got)
    for w, lane, k in ((3, 0, keys[3] + 1), (W - 1, npts - 1, keys[W - 1])):
        d = hashref.pubkey_to_eth_address(ecref.scalar_mult(k))
        j = w * npts + lane
        if [lo[j], hi[j]] != [int.from_bytes(d[0:4], "little"), int.from_bytes(d[4:8], "little")]:
            fail(f"keccak_eth point {j} differs from hashref")
    bms, by_ = bound_ms(n * HASH_OPS["keccak"], 72 * n, clock)
    results["keccak_eth"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                                 bound_by=by_)
    log(f"keccak_eth n={n}: equal to plain and to hashref on a sample; {ms:.4f} ms "
        f"(plain {pms:.1f} ms, bound {bms:.4f} ms by {by_})")

    # K7 and K8 on the step's points (rmd160 and address_u / rmd160_both)
    for name, fn, ref, ops, nbytes in (
            ("hash160_x2", lambda: phash.hash160_x2_from_batch(x),
             lambda: phash.hash160_x2_ref(x), 2 * HASH_OPS["hash160"], 48),
            ("hash160_u", lambda: phash.hash160_u_from_batch(x, y),
             lambda: phash.hash160_u_ref(x, y), HASH_OPS["hash160_u"], 72)):
        ms, got = device_ms(fn, 20)
        pms, want = timed(ref, 1)
        flat = lambda o: [t for pair in o for t in pair] if name == "hash160_x2" else list(o)
        err = max_abs_err(flat(got), flat(want))
        if err:
            fail(f"{name} differs from its plain version at n={n} (max_abs_err {err})")
        bms, by_ = bound_ms(n * ops, n * nbytes, clock)
        log(f"{'K7' if name == 'hash160_x2' else 'K8'} {name} n={n} (the walker step): equal "
            f"to plain; {ms:.4f} ms (plain {pms:.1f} ms, bound {bms:.4f} ms by {by_})")

    # the probe on the step's rmd160 queries against a 2^34-bit bitmap
    (le, he), (lo_, ho_) = phash.hash160_x2_from_batch(x)
    qhi, qlo = torch.cat([he, ho_]), torch.cat([le, lo_])
    B = qhi.shape[0]
    dummy = bmp.empty_filter(10, dev)

    def filled(bits, keys_hi, keys_lo, level2):
        """A 2^bits filter of the keys: the bitmap, or (level2) the bloom2."""
        words = bmp.empty_filter(bits, dev)
        if level2:
            bmp.insert_keys(dummy, 10, words, bits, keys_hi, keys_lo, keys_hi.shape[0])
        else:
            bmp.insert_keys(words, bits, None, 0, keys_hi, keys_lo, keys_hi.shape[0])
        return words

    rnd = lambda k: torch.from_numpy(rng.integers(-2**31, 2**31, k).astype(np.int32)).to(dev)
    members = 1000  # the first queries are members, the rest almost all not
    words = filled(WK_BITS, torch.cat([qhi[:members], rnd(WK_T - members)]),
                   torch.cat([qlo[:members], rnd(WK_T - members)]), False)
    bm = bmp.DeviceBitmap(words, WK_BITS)
    ms, got = device_ms(lambda: bmp.probe(bm, qhi, qlo), 50)
    pms, want = timed(lambda: bmp.probe_ref(bm, qhi, qlo), 3)
    err = max_abs_err([got], [want])
    if err or not bool(got[:members].all()):
        fail(f"probe differs from its plain version or misses a member (max_abs_err {err})")
    word_idx = bmp.bitmap_bit_planes(fe.u32(qhi), fe.u32(qlo), WK_BITS)[0]
    lib_ms, _ = device_ms(lambda: words[word_idx], 50)
    bms, by_ = bound_ms(12 * B, PROBE_BYTES * B, clock)
    log(f"probe B={B} against 2^{WK_BITS} bits ({WK_T} keys): equal to plain, members found, "
        f"{int(got.sum())} set; {ms:.4f} ms (plain {pms:.3f} ms, words[idx] "
        f"{lib_ms:.4f} ms, bound {bms:.4f} ms by {by_}: {PROBE_BYTES} B a query)")
    # the fused form at the walker's cand_max, its survivors in order
    cmax = 256
    ms, got = device_ms(lambda: bmp.probe_compact(bm, qhi, qlo, cmax), 50)
    pms, want = timed(lambda: bmp.probe_compact_ref(bm, qhi, qlo, cmax), 3)
    err = max_abs_err(got, want)
    if err or int(got.n) < members:
        fail(f"probe_compact differs from its plain version (max_abs_err {err})")
    log(f"probe_compact B={B} C={cmax}: equal to plain ({int(got.n)} survivors, the first "
        f"{cmax} in order); {ms:.4f} ms (plain {pms:.3f} ms)")

    # the step's exact lookup and summary at the walker's shape
    largs, n_live = walker_lookup_inputs(qhi, qlo, deg, adeg, rng)
    total = largs[-1]
    table, lpos, lqhi, lqlo = largs[:4]
    ms, got = device_ms(lambda: st.lookup_summary(*largs), 50)
    pms, want = timed(lambda: st.lookup_summary_ref(*largs), 3)
    err = max_abs_err([got], [want])
    g = got.cpu().numpy()
    n_hit = int((g[:cmax] < total).sum())
    if err or n_hit != n_live or (g[2 * cmax + 2], g[2 * cmax + W + 2]) != (1, 8):
        fail(f"lookup_summary differs from its plain version (max_abs_err {err}) or from the "
             f"planted hits ({n_hit} of {n_live})")
    lib_ms, _ = device_ms(lambda: st.lookup(table, lqhi, lqlo), 50)
    one = (table, lpos[:1], lqhi[:1], lqlo[:1], largs[4], deg[:1], adeg[:1], total)
    floor_ms, _ = device_ms(lambda: st.lookup_summary(*one), 50)
    flush = torch.empty((1 << 24,), dtype=torch.int32, device=dev)  # 64 MB, past the L2
    cms = cold_ms(lambda: st.lookup_summary(*largs), flush)
    floor_cms = cold_ms(lambda: st.lookup_summary(*one), flush)
    levels = WK_T.bit_length()  # ceil(log2(m + 1)) dependent reads a search
    bms, by_ = bound_ms(cmax * levels * 8 + W * U // 4,
                        cmax * (16 + 8 * (levels + 2)) + W * U + W + 4 * (2 * cmax + 3 * W + 2),
                        clock)
    results["lookup_summary"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                                     bound_by=by_, library_ms=lib_ms, latency_floor_ms=floor_ms,
                                     cold_ms=cms, latency_floor_cold_ms=floor_cms)
    log(f"lookup_summary C={cmax} W={W} U={U} m={WK_T}: equal to plain, {n_hit} live hits (the "
        f"degenerate lanes' dropped, walker 2's first degenerate lane 8); {ms:.4f} ms, cold L2 "
        f"{cms:.4f} ms (plain {pms:.3f} ms, sorted_table.lookup {lib_ms:.4f} ms, bound "
        f"{bms:.5f} ms by {by_}, latency floor (C = 1, W = 1) {floor_ms:.4f} ms, cold L2 "
        f"{floor_cms:.4f} ms)")
    del table, largs, lpos, lqhi, lqlo, one, flush
    # the cases of tests/walker_lookup_cases.py: found2, a key above the
    # table, tables of 1, 32, 33, 34, 1,089 and 1,090 keys (the 32-ary
    # search's edges), a duplicate across a pivot, the table's first and last
    # keys, padding, degenerate hits, overflow, more walkers and survivors
    # than a block holds
    import walker_lookup_cases as wlc

    i32 = lambda a: torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy()).to(dev)
    for case in wlc.CASES:
        d = wlc.make_case(case)
        ctab = st.build_sorted_table(d["hi"], d["lo"], d["idx"], dev)
        cargs = (ctab, torch.from_numpy(d["pos"]).to(dev), i32(d["qhi"]), i32(d["qlo"]),
                 torch.tensor(d["n"], dtype=torch.int32, device=dev),
                 torch.from_numpy(d["deg"]).to(dev), torch.from_numpy(d["adeg"]).to(dev),
                 d["total"])
        e = max_abs_err([st.lookup_summary(*cargs)], [st.lookup_summary_ref(*cargs)])
        if e:
            fail(f"lookup_summary differs from its plain version on case {case} "
                 f"(max_abs_err {e})")
    log(f"lookup_summary: equal to plain on the {len(wlc.CASES)} cases of "
        f"walker_lookup_cases ({', '.join(wlc.CASES)})")
    del words, bm, word_idx
    torch.cuda.empty_cache()

    # bloom2 form at phase 3's sizes: C1 = 34,816 stage-1 survivors, 2^35 bits
    n2 = 34816
    q2h, q2l = rnd(n2), rnd(n2)
    words = filled(MAIN_BITS, torch.cat([q2h[:members], rnd(WK_T - members)]),
                   torch.cat([q2l[:members], rnd(WK_T - members)]), True)
    b2 = bmp.DeviceBloom2(words, MAIN_BITS)
    ms2, got = device_ms(lambda: bmp.probe_bloom2(b2, q2h, q2l), 50)
    pms2, want = timed(lambda: bmp.probe_bloom2_ref(b2, q2h, q2l), 3)
    err2 = max_abs_err([got], [want])
    if err2 or not bool(got[:members].all()):
        fail(f"probe (bloom2) differs from its plain version or misses a member")
    bms2, by2 = bound_ms(40 * n2, (2 * 32 + 9) * n2, clock)
    log(f"probe bloom2 n={n2} against 2^{MAIN_BITS} bits: equal to plain, members found; "
        f"{ms2:.4f} ms (plain {pms2:.3f} ms, bound {bms2:.4f} ms by {by2})")
    del words, b2, dummy
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


def phase1_bsgs(dev, results, clock):
    """The BSGS chunk's cascade after the level-1 probe at the main path's
    shape: the bloom2 stage (kh_bloom2_compact) on C1 = 34,816 stage-1
    survivors of 4,194,304 queries into C2 = 1,536 against host resolve's
    2^35-bit bloom2 and a device table's 2^32-bit one, and the summary
    (kh_bsgs_summary) of C2 survivors over 256 rows of U = 16,384 and a
    2^28-key table, in both resolve modes; each against its plain version
    at data the main path gives it (a filter's density, the survivors a
    chunk has) and at denser data (a stage-2 overflow; flags on many rows,
    advance-only lanes, hits on degenerate lanes), timed beside the torch
    composition it replaced, and again at m = 2^30's shape (C1 = 134,656,
    131,072 live, at the 2^35-bit bloom2's density 1/16; C2 = 1,536 with the 482
    survivors its budget expects); the bloom2 stage also with a zero fill
    of its scratch before each launch, one more device operation as PR
    16's memset was (device operations and ms), and the summary also with a cold L2 (a 64 MB fill
    between runs, as a chunk's probe leaves it). Then the scratch-reuse
    gate: 1,200 launches of the compact kernels on two streams, each on
    its stream's scratch pair, C1 between tile boundaries, each equal to
    its plain version, each stream's next scratch zero after."""
    import torch

    from keyhuntm1cpu_tpu_torch import _build
    from keyhuntm1cpu_tpu_torch.engine import bsgs
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp
    from keyhuntm1cpu_tpu_torch.filter import sorted_table as st

    g = torch.Generator(device=dev).manual_seed(16)
    rnd = lambda k: torch.randint(-2**31, 2**31, (k,), dtype=torch.int32, device=dev,
                                  generator=g)
    B, (C1, C2), R = K * U, CASCADE_C, K  # T = 1
    flush = torch.empty((1 << 24,), dtype=torch.int32, device=dev)  # 64 MB, past the L2

    def bloom(bits, ands):
        """2^bits bloom2 bits, each set with probability 2^-ands."""
        w = rnd(1 << (bits - 5))
        for _ in range(ands - 1):
            w &= rnd(1 << (bits - 5))
        return bmp.DeviceBloom2(w, bits)

    def stage1(n1, c1=C1):
        pos = torch.full((c1,), B, dtype=torch.int32, device=dev)
        k = min(n1, c1)
        pos[:k] = torch.sort(torch.randperm(B, device=dev, generator=g)[:k]).values.int()
        qh, ql = rnd(c1), rnd(c1)
        qh[k:], ql[k:] = qh[-1].item(), ql[-1].item()
        return bmp.ProbeCompact(pos, qh, ql, torch.tensor(n1, dtype=torch.int32, device=dev))

    def replaced_stage(b2, s1, c2=C2):
        """The bloom2 stage before its kernel: the bloom2 probe kernel, then torch ops."""
        pos1, qh1, ql1, n1 = s1
        c1 = pos1.shape[0]
        mask2 = bmp.probe_bloom2(b2, qh1, ql1) & (pos1 < B)
        pos2 = bmp.compact_positions(mask2, c2, c1)
        safe2 = pos2.clamp(max=c1 - 1).long()
        return (torch.where(pos2 < c1, pos1[safe2], B), qh1[safe2], ql1[safe2],
                torch.where(n1 > c1, n1 + c2, mask2.sum(dtype=torch.int32)))

    def time_stage(b2, s1, c2):
        """(ms, plain ms, replaced ms, bound ms, bound_by, survivors) of the bloom2 stage."""
        c1 = s1.pos.shape[0]
        ms, got = device_ms(lambda: bmp.bloom2_compact(b2, s1, B, c2), 50)
        pms, _ = timed(lambda: bmp.bloom2_compact_ref(b2, s1, B, c2), 3)
        rms, _ = device_ms(lambda: replaced_stage(b2, s1, c2), 50)
        live1 = min(int(s1.n), c1)
        bms, by_ = bound_ms(40 * live1, 12 * c1 + 64 * live1 + 12 * c2 + 8, clock)
        return ms, pms, rms, bms, by_, int(got.n)

    # the bloom2 stage: m = 2^28 fills 2m of 2^35 bits (host) and of 2^32 (device)
    n1 = B * (1 << 28) >> MAIN_BITS  # the level-1 survivors of a chunk at m = 2^28
    for bits, ands, n in ((MAIN_BITS, 6, n1), (32, 3, n1), (MAIN_BITS, 2, C1), (32, 2, n1 // 2)):
        b2, s1 = bloom(bits, ands), stage1(n)
        got = bmp.bloom2_compact(b2, s1, B, C2)
        want = bmp.bloom2_compact_ref(b2, s1, B, C2)
        e = max_abs_err(got, want) + max_abs_err(got, replaced_stage(b2, s1))
        if e:
            fail(f"bloom2_compact differs from its plain version at 2^{bits} bits, density "
                 f"2^-{ands}, n1 {n} (max_abs_err {e})")
        if bits == MAIN_BITS and ands == 6:
            ms, pms, rms, bms, by_, n2 = time_stage(b2, s1, C2)
            # as PR 16 launched it: the scratch zeroed first, then the kernel
            st_ = _build.stream(s1.qhi)
            pair = bmp._COMPACT.pairs[(st_.device, int(st_))]
            with_fill = lambda: (pair[0][pair[1]].zero_(), bmp.bloom2_compact(b2, s1, B, C2))[1]
            fms, _ = device_ms(with_fill, 50)
            ops, memsets = device_ops(lambda: bmp.bloom2_compact(b2, s1, B, C2))
            ops0, memsets0 = device_ops(with_fill)
            results["bloom2_compact"] = dict(max_abs_err=0, ms=ms, plain_ms=pms, bound_ms=bms,
                                             bound_by=by_, replaced_ms=rms, with_fill_ms=fms)
            log(f"bloom2_compact C1={C1} ({min(n, C1)} live, {-(-C1 // bmp._probe_tile(True))} "
                f"tiles) -> C2={C2} against 2^{bits} bits (density 1/64): equal to plain and to "
                f"the torch composition, {n2} survivors; {ms:.4f} ms (plain {pms:.3f} ms, the "
                f"composition it replaced {rms:.4f} ms on the card, bound {bms:.5f} ms by "
                f"{by_}); with a zero fill of its scratch first, as PR 16's memset, "
                f"{fms:.4f} ms; device operations {ops} ({memsets} memsets) a stage, {ops0} "
                f"({memsets0} memsets) with the fill")
        else:
            log(f"bloom2_compact at 2^{bits} bits, density 2^-{ands}, n1 {n}: equal to plain "
                f"({int(got.n)} survivors{', past C2' if int(got.n) > C2 else ''})")
        del b2, s1, got, want
        torch.cuda.empty_cache()

    # m = 2^30 (host resolve, the bench's headline): C1 = 134,656 stage-1
    # entries, B * 2^30 / 2^35 = 131,072 of them live, bloom2 load 2m/2^35
    c1_30, c2_30 = CASCADE_30
    n1_30 = B * (1 << 30) >> MAIN_BITS
    b2, s1 = bloom(MAIN_BITS, 4), stage1(n1_30, c1_30)
    got = bmp.bloom2_compact(b2, s1, B, c2_30)
    e = max_abs_err(got, bmp.bloom2_compact_ref(b2, s1, B, c2_30)) + max_abs_err(
        got, replaced_stage(b2, s1, c2_30))
    if e:
        fail(f"bloom2_compact differs from its plain version at m = 2^30's shape (max_abs_err {e})")
    ms, pms, rms, bms, by_, n2 = time_stage(b2, s1, c2_30)
    results["bloom2_compact"] |= dict(ms_m30=ms, replaced_ms_m30=rms, bound_ms_m30=bms)
    log(f"bloom2_compact at m = 2^30's shape: C1={c1_30} ({n1_30} live, "
        f"{-(-c1_30 // bmp._probe_tile(True))} tiles) -> C2={c2_30} against 2^{MAIN_BITS} bits "
        f"(density 1/16): equal to plain and to the torch composition, {n2} survivors; "
        f"{ms:.4f} ms (plain {pms:.3f} ms, the composition it replaced {rms:.4f} ms, bound "
        f"{bms:.5f} ms by {by_})")
    del b2, s1, got
    torch.cuda.empty_cache()

    # the summary: a 2^28-key table, survivors with planted hits
    m = CASCADE_M
    key = torch.sort((rnd(m).to(torch.int64) << 32) | (rnd(m).to(torch.int64) & 0xFFFFFFFF)).values
    key[-1] = key[-2]  # a duplicated truncated key: found2
    table = st.SortedXTable(key, torch.arange(1, m + 1, dtype=torch.int32, device=dev))
    levels = m.bit_length()

    def inputs(n, dense):
        """n survivors (every other one a table key, every 7th the duplicated
        one), the (R, U) flags and the advance flags."""
        pos = torch.full((C2,), B, dtype=torch.int32, device=dev)
        pos[:n] = torch.sort(torch.randperm(B, device=dev, generator=g)[:n]).values.int()
        pick = key[torch.randint(0, m - 1, (C2,), device=dev, generator=g)]
        pick[1::7] = key[-1]
        hit = torch.arange(C2, device=dev) % 2 == 1
        hh, hl = st.key_words(pick)
        qh, ql = torch.where(hit, hh, rnd(C2)), torch.where(hit, hl, rnd(C2))
        deg = torch.zeros((R, U), dtype=torch.bool, device=dev)
        adv = torch.zeros((R,), dtype=torch.bool, device=dev)
        rows = torch.arange(0, R, 4 if dense else 64, device=dev)
        deg[rows, (37 * rows) % (U - 1)] = True
        adv[rows[1::2]] = True
        if dense:  # survivors on flagged lanes and on lane U - 1 of advance rows
            deg |= torch.rand((R, U), device=dev, generator=g) < 0.001
            lanes = torch.nonzero(deg.reshape(-1))[:, 0][: n // 8].int()
            pos[: len(lanes)] = lanes
            pos[len(lanes): 2 * len(lanes)] = (rows[1::2] * U + U - 1).int().repeat(
                len(lanes))[: len(lanes)]
            pos[:n] = torch.sort(pos[:n]).values
        return (pos, qh.contiguous(), ql.contiguous(),
                torch.tensor(n, dtype=torch.int32, device=dev), deg, adv)

    for name, tab in (("chunk_summary", table), ("chunk_summary_host", None)):
        fn = ((lambda *a: bsgs.chunk_summary(table, *a)) if tab is not None
              else bsgs.chunk_summary_host)
        for n, dense in ((C2 // 3, False), (C2 - 100, True), (0, True), (482, False)):
            pos, qh, ql, cnt, deg, adv = inputs(n, dense)
            args = (pos, qh, ql, cnt, deg, adv, (deg, adv))
            got = fn(*args)
            want = bsgs.chunk_summary_ref(tab, *args)
            e = max_abs_err([got], [want])
            w = want.cpu().numpy()
            live = int((w[:C2] < B).sum())
            if e or (tab is not None and n and not live):
                fail(f"{name} differs from its plain version (n {n}, dense {dense}, "
                     f"max_abs_err {e}) or found no planted hit ({live} live)")
            if dense:
                log(f"{name} n={n} with dense flags: equal to plain ({live} live)")
                continue
            ms, _ = device_ms(lambda: fn(*args), 50)
            cms = cold_ms(lambda: fn(*args), flush)
            rms, _ = device_ms(lambda: bsgs.chunk_summary_ref(tab, *args), 50)
            searched = int(((pos < B) & ~deg.reshape(-1)[pos.clamp(max=B - 1).long()])
                           .sum()) if tab is not None else 0
            out_b = 4 * (3 * C2 + 3 * R + 1)
            bms, by_ = bound_ms(searched * levels * 8 + R * U // 4,
                                R * U + R + 12 * C2 + 4 + searched * 8 * (levels + 2)
                                + out_b, clock)
            if n == 482:  # m = 2^30's C2 and expected survivors
                results[name] |= dict(ms_m30=ms, cold_ms_m30=cms, bound_ms_m30=bms)
                log(f"{name} at m = 2^30's shape (C2={C2}, {n} survivors, {searched} "
                    f"searched): equal to plain; {ms:.4f} ms, cold L2 {cms:.4f} ms (the "
                    f"composition it replaced {rms:.4f} ms, bound {bms:.5f} ms by {by_})")
                continue
            pms, _ = timed(lambda: bsgs.chunk_summary_ref(tab, *args), 3)
            results[name] = dict(max_abs_err=0, ms=ms, plain_ms=pms, bound_ms=bms,
                                 bound_by=by_, replaced_ms=rms, cold_ms=cms)
            log(f"{name} C2={C2} ({n} survivors, {searched} searched over "
                f"2^{m.bit_length() - 1} keys, {live} live) R={R} U={U}: equal to plain; "
                f"{ms:.4f} ms, cold L2 {cms:.4f} ms (plain {pms:.3f} ms, the composition it "
                f"replaced {rms:.4f} ms on the card, bound {bms:.5f} ms by {by_})")
        # the ring's two forms: candidates without rows, rows without candidates
        pos, qh, ql, cnt, deg, adv = inputs(C2 - 100, True)
        none = pos[:0]
        for args in ((pos, qh, ql, cnt, deg, adv, None), (none, none, none, cnt, deg, adv,
                                                           (deg, adv))):
            e = max_abs_err([fn(*args)], [bsgs.chunk_summary_ref(tab, *args)])
            if e:
                fail(f"{name}'s ring forms differ from the plain version (max_abs_err {e})")
        log(f"{name}: the ring's forms (no rows; no candidates) equal to plain")
    del table, key, flush
    torch.cuda.empty_cache()
    scratch_reuse_gate(dev)
    torch.cuda.synchronize()


def scratch_reuse_gate(dev):
    """1,200 launches of the compact kernels back to back, taking turns on
    two streams, each on its own stream's scratch pairs with no memset:
    1,000 on the bitmap pair, the bloom2 stage at C1 between tile boundaries (one below, at and one above
    135 tiles, the main path's 136 and m = 2^30's 526; 255 and 257) against
    the 2^35-bit bloom2, every fifth launch a level-1 form, in turns the
    probe's at the main path's 4,194,304 queries and one more (a 2^35-bit
    bitmap of m = 2^28's density, into C1 = 34,816) and the mask
    compaction's (kh_mask_compact) of a mask of that density over 256 and
    257 rows of U = 16,352 (511 tiles and a ragged 513th), and after every
    fifth of them the
    fused brute chunk's compaction on its own pair (200 launches of
    kh_compact_hits at K = 256, U = 16,384, C = 1,024: a few hits, R + 1
    flagged rows, dense rows with degenerate words), so the probe's and the
    compaction's launches interleave on each stream;
    each result equal to its plain version's (computed first), every
    stream's next scratch zero after (the compaction's: its ticket)."""
    import torch

    from keyhuntm1cpu_tpu_torch.curve import pbrute
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp

    g = torch.Generator(device=dev).manual_seed(17)
    rnd = lambda k: torch.randint(-2**31, 2**31, (k,), dtype=torch.int32, device=dev,
                                  generator=g)
    B = K * U
    tile = bmp._probe_tile(True)
    b2 = bmp.DeviceBloom2(rnd(1 << (MAIN_BITS - 5)) & rnd(1 << (MAIN_BITS - 5)), MAIN_BITS)
    words = rnd(1 << (MAIN_BITS - 5))
    for _ in range(6):
        words &= rnd(1 << (MAIN_BITS - 5))
    bm = bmp.DeviceBitmap(words, MAIN_BITS)  # density 1/128, m = 2^28's: ~32,768 pass
    stages, level1, compacts = [], [], []
    for c1 in (135 * tile - 1, 135 * tile, 135 * tile + 1, CASCADE_C[0], CASCADE_30[0],
               tile - 1, tile + 1):
        pos = torch.sort(torch.randperm(B, device=dev, generator=g)[:c1]).values.int()
        s1 = bmp.ProbeCompact(pos, rnd(c1), rnd(c1),
                              torch.tensor(c1, dtype=torch.int32, device=dev))
        stages.append((s1, bmp.bloom2_compact_ref(b2, s1, B, c1 // 3)))
    for n in (B, B + 1):
        q = (rnd(n), rnd(n))
        level1.append((bmp.probe_compact, (bm, *q),
                       bmp.probe_compact_ref(bm, *q, CASCADE_C[0])))
    for rows in (K, K + 1):
        mask = rnd(rows * 511).reshape(rows, 511)
        for _ in range(6):
            mask &= rnd(rows * 511).reshape(rows, 511)
        q = (rnd(rows * 16352), rnd(rows * 16352))
        level1.append((bmp.mask_compact, (mask, *q),
                       bmp.mask_compact_ref(mask, *q, CASCADE_C[0])))
    C = 1024
    R = pbrute.row_budget(C)
    adeg = torch.zeros(K, dtype=torch.bool, device=dev)
    adeg[[0, K - 1]] = True
    for n_rows, per_row in ((3, 1), (R + 1, 2), (R, 128)):
        h = torch.zeros((B // pbrute.LANES, pbrute.LANES), dtype=torch.int32, device=dev)
        rows = torch.randperm(B // pbrute.LANES, device=dev, generator=g)[:n_rows]
        h[rows, :per_row] = rnd(n_rows * per_row).reshape(n_rows, per_row) & (1 << 31) - 1
        h = h.reshape(K, U)
        compacts.append((h, pbrute.compact_hits_ref(h, adeg, C)))
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    torch.cuda.synchronize()
    runs = []
    t0 = time.time()
    for i in range(1000):
        with torch.cuda.stream(streams[i % 2]):
            if i % 5 == 4:
                fn, args, want = level1[(i // 5) % len(level1)]
                runs.append((fn(*args, want.pos.shape[0]), want))
            else:
                s1, want = stages[i % len(stages)]
                runs.append((bmp.bloom2_compact(b2, s1, B, want.pos.shape[0]), want))
            if i % 5 == 2:
                h, want = compacts[i % len(compacts)]
                runs.append(([pbrute.compact_hits(h, adeg, C)], [want]))
    torch.cuda.synchronize()
    dt = time.time() - t0
    bad = sum(1 for got, want in runs if max_abs_err(got, want))
    dirty = [k for k, (buf, turn) in bmp._COMPACT.pairs.items() if int(buf[turn].abs().sum())]
    dirty += [k for k, (buf, turn) in pbrute._COMPACT.pairs.items()
              if int(buf[turn][0])]
    if bad or dirty:
        fail(f"scratch reuse: {bad} of 1,200 launches differ from the plain version; "
             f"scratches left non-zero: {dirty}")
    log(f"scratch reuse: 1,200 compact launches on two streams (800 bloom2 stages at C1 "
        f"{', '.join(str(s.pos.shape[0]) for s, _ in stages)}, 200 level-1: kh_probe_compact "
        f"at B {B} and {B + 1}, kh_mask_compact over {K} and {K + 1} rows of U 16352; "
        f"200 kh_compact_hits at K={K} U={U} C={C} with 3, R + 1 and R dense "
        f"flagged rows) each equal to its plain version, the next scratch of each of "
        f"{len(bmp._COMPACT.pairs)} + {len(pbrute._COMPACT.pairs)} stream pairs zero after, "
        f"{dt:.2f} s")
    del runs, stages, level1, compacts, b2, bm, words
    torch.cuda.empty_cache()


def bsgs_params(m, resolve, **kw):
    """The main path's BSGS shape (bench.py's): U, K, build_block, 2^35-bit
    bitmap (and host-resolve bloom2)."""
    from keyhuntm1cpu_tpu_torch.engine.bsgs import BSGSParams

    return BSGSParams(m=m, block_u=U, steps_per_chunk=K, build_block=BUILD_BLOCK,
                      bits_log2=MAIN_BITS, bloom2_bits=MAIN_BITS, resolve=resolve, **kw)


def phase2_small(dev):
    from keyhuntm1cpu_tpu_torch.engine.bsgs import BSGSEngine, BSGSParams
    from keyhuntm1cpu_tpu_torch.ref import ecref

    span = K * U * 2 * SMALL_M  # keys per chunk
    a, b = 1 << 44, (1 << 44) + 4 * span
    keys = [a + 12345678901 % span, a + 2 * span + 987654321 % span, b - 5]
    for resolve in ("host", "device"):
        params = BSGSParams(m=SMALL_M, block_u=U, steps_per_chunk=K,
                            build_block=BUILD_BLOCK, chunk_cand_max=1024, resolve=resolve)
        t0 = time.time()
        eng = BSGSEngine([ecref.scalar_mult(k) for k in keys], a, b, params, device=dev)
        found = sorted(f.private_key for f in eng.search(stop_on_first=False))
        if found != sorted(keys):
            fail(f"phase 2 ({resolve} resolve): found {[hex(k) for k in found]}, planted "
                 f"{[hex(k) for k in keys]}")
        log(f"phase 2: {resolve} resolve, m=2^{SMALL_M.bit_length() - 1}, 3 planted keys "
            f"found exactly in {time.time() - t0:.1f} s")


def launch_counts():
    """(kernel -> its wrappers, kernel -> launches): each wrapper counts the
    launches of its kernel; the probe kernel has two wrappers."""
    from keyhuntm1cpu_tpu_torch import _build

    wrappers = _build.kernel_wrappers()
    return wrappers, {name: sum(w.launches for w in ws) for name, ws in wrappers.items()}


def reset_counts():
    """Set every kernel's launch count to 0."""
    for ws in launch_counts()[0].values():
        for w in ws:
            w.launches = 0


def zero_counts():
    return dict.fromkeys(KERNEL_SOURCES, 0)


def delta(after, before):
    return {name: after[name] - before[name] for name in after}


def chunk_launches(eng, n, d=1):
    """The launches of n chunks of a BSGS engine, d of them a chunk (the
    range-sharded engine's shards): K1, K2 with the level-1 probe, the
    compaction of its mask, the bloom2 stage (where the engine has a
    bloom2) and the summary of its resolve mode."""
    summary = "chunk_summary_host" if eng.table is None else "chunk_summary"
    return zero_counts() | {"advance_chain": d * n, "walk_blocks": d * n,
                            "mask_compact": d * n,
                            "bloom2_compact": d * n if eng.bloom2 is not None else 0,
                            summary: d * n}


def phase3_main(dev, m, seconds, results, clock):
    """The main path; returns its launch counts, counted from zero."""
    import numpy as np
    import torch

    from keyhuntm1cpu_tpu_torch.curve import pwalk
    from keyhuntm1cpu_tpu_torch.engine.bsgs import (BUILD_BLOCKS, BSGSEngine,
                                                     chunk_impl_host, filter_build_step)
    from keyhuntm1cpu_tpu_torch.field import fe
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp
    from keyhuntm1cpu_tpu_torch.filter import host_table as ht
    from keyhuntm1cpu_tpu_torch.ref import ecref

    params = bsgs_params(m, "host")
    t0 = time.time()
    htab = ht.ensure_host_table(m, progress=True)
    htab.prefault()
    t_table = time.time() - t0
    log(f"phase 3: host table m=2^{m.bit_length() - 1} ready in {t_table:.1f} s "
        f"(native build + prefault)")
    pub63 = ecref.scalar_mult(PUZZLE63_KEY)

    # the main path's run: every launch from here to the end of the
    # throughput window is counted
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    eng = BSGSEngine([pub63], 1 << 63, 1 << 64, params, device=dev, host_table=htab)
    torch.cuda.synchronize()
    t_build = time.time() - t0
    _, n_build = launch_counts()
    build_steps = max(0, -(-(m - 2 * BUILD_BLOCK) // (BUILD_BLOCKS * BUILD_BLOCK)))
    want = zero_counts() | dict(advance_chain=build_steps, walk_blocks=build_steps,
                                insert_keys=build_steps + 1)  # + the native seed's insert
    if n_build != want:
        fail(f"streaming build launched {n_build}, expected {want}")
    log(f"phase 3: streaming filters (bits={eng.bitmap.bits_log2}, "
        f"b2={eng.bloom2.bits_log2}, {2 * eng.bitmap.words.numel() * 4 / 2**30:.0f} GiB) "
        f"built on the card in {t_build:.2f} s; launches {n_build}")

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
    if d63["advance_chain"] < 1 or d63 != chunk_launches(eng63, d63["advance_chain"]):
        fail(f"puzzle-63 search launched {d63}, expected K1 == K2 == probe == bloom2_compact "
             "== chunk_summary_host >= 1 and nothing else")
    log(f"phase 3: puzzle-63 key 0x{PUZZLE63_KEY:x} recovered bit-exact in "
        f"{time.time() - t0:.2f} s; launches {d63}")

    # throughput; a CUDA event pair around each chunk's work on the stream
    # gives the device's busy time (the summary copies fall in the gaps)
    eng64 = BSGSEngine([ecref.scalar_mult(PUZZLE64_KEY)], 1 << 63, 1 << 64, params,
                       device=dev, host_table=htab, bitmap=eng.bitmap, bloom2=eng.bloom2)
    marks, enqueue = marked(eng64)
    torch.cuda.synchronize()
    t0 = time.time()
    found = eng64.search(max_seconds=seconds, stop_on_first=False)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    if any(f.private_key != PUZZLE64_KEY for f in found):
        fail(f"throughput search found a wrong key: {[hex(f.private_key) for f in found]}")
    _, n_main = launch_counts()
    d64 = delta(n_main, n63)
    chunks = eng64.stats.keys_covered // (K * U * eng64.stride)
    if d64 != chunk_launches(eng64, len(marks)) or chunks != len(marks):
        fail(f"throughput search launched {d64} for {len(marks)} chunks dispatched, "
             f"{chunks} counted")
    keys_per_sec = eng64.stats.keys_covered / elapsed
    busy = sum(a.elapsed_time(b) for a, b in marks)
    span = marks[0][0].elapsed_time(marks[-1][1])
    log(f"phase 3: throughput {chunks} chunks in {elapsed:.2f} s -> "
        f"{keys_per_sec:.4e} keys/s (= chunks*K*U*2m/s; K={K}, U={U}, "
        f"m=2^{m.bit_length() - 1}); puzzle 64's key "
        f"{'found bit-exact' if found else 'not reached'} on the way; launches {d64}")
    log(f"phase 3: device idle share {1 - busy / span:.4f} over the window "
        f"(busy {busy:.1f} of {span:.1f} ms between the first chunk's start and the "
        f"last one's end; {busy / chunks:.3f} ms per chunk); host enqueue "
        f"{1000 * sum(enqueue) / chunks:.3f} ms per chunk")

    # chunk-time split on the card (device_ms): whole chunk, K1 alone, K2
    # alone; the cascade is the rest; host decode by wall clock
    reps = 10
    px, py = eng64._initial_base(0)
    tot_ms, outs = device_ms(lambda: chunk_impl_host(
        px, py, eng64.tab_x, eng64.tab_y, eng64.adv_x, eng64.adv_y, eng64.bitmap,
        eng64.bloom2, U=U, K=K, T=1, C1=eng64.C1, C2=eng64.C2, adv_tab=eng64.adv_tab,
        pair_tab=eng64.pair_tab), reps)
    pxt, pyt = px.t().contiguous(), py.t().contiguous()
    pt = eng64.pair_tab  # the paired walk: K1 with the centres, K2 over pairs
    k1_ms, (bx, by, _, _, _, *cen) = device_ms(lambda: pwalk.advance_chain(
        pxt, pyt, eng64.adv_x, eng64.adv_y, K, eng64.adv_tab, pt and pt[2:]), reps)
    pairs = (*pt[:2], *cen) if pt else None
    k2_ms, _ = device_ms(lambda: pwalk.walk_blocks(bx, by, eng64.tab_x, eng64.tab_y, None,
                                                   pairs), reps)
    # the cascade on this chunk's queries, once through the probe kernels and
    # once through their plain versions: the level-1 bitmap probe of the
    # T*K*U queries fused with its compaction to C1, the bloom2 probe of the
    # C1 stage-1 survivors, compaction to C2 (bmp.filtered_survivors' stages)
    bm, b2 = eng64.bitmap, eng64.bloom2
    res = pwalk.chunk_multi(px, py, eng64.tab_x, eng64.tab_y, eng64.adv_x, eng64.adv_y,
                            K=K, U=U, T=1, adv_tab=eng64.adv_tab, pair_tab=eng64.pair_tab)
    qhi, qlo = res.qhi.reshape(-1), res.qlo.reshape(-1)
    B = qhi.shape[0]

    C1, C2 = eng64.C1, eng64.C2

    def cascade(level1, probe2):
        pos1, qh1, ql1, n = level1(bm, qhi, qlo, C1)
        mask2 = probe2(b2, qh1, ql1) & (pos1 < B)
        return pos1, qh1, ql1, n, mask2, bmp.compact_positions(mask2, C2, C1)

    def composition():
        """The level-1 stage before its fusion (PR 6): the mask form, the
        count, compact_positions and the key gathers."""
        mask = bmp.probe(bm, qhi, qlo)
        n = mask.sum(dtype=torch.int32)
        pos1 = bmp.compact_positions(mask, C1, B)
        safe1 = pos1.clamp(max=B - 1).long()
        return pos1, qhi[safe1], qlo[safe1], n

    got = cascade(bmp.probe_compact, bmp.probe_bloom2)
    want = cascade(bmp.probe_compact_ref, bmp.probe_bloom2_ref)
    err = max_abs_err(got, want)
    if err or max_abs_err(composition(), got[:4]):
        fail(f"phase 3: the cascade through the fused probe differs from the plain probes' "
             f"or from the composition it replaced (max_abs_err {err})")
    n1, qh1, ql1 = int(got[3]), got[1], got[2]
    pr_ms, _ = device_ms(lambda: bmp.probe_compact(bm, qhi, qlo, C1), reps)
    ppr_ms, _ = timed(lambda: bmp.probe_compact_ref(bm, qhi, qlo, C1), reps)
    comp_ms, _ = device_ms(composition, reps)
    mask_ms, _ = device_ms(lambda: bmp.probe(bm, qhi, qlo), reps)
    cas_ms, _ = device_ms(lambda: bmp.filtered_survivors(bm, qhi, qlo, C2, bm2=b2,
                                                         stage1_max=C1), reps)
    word_idx = bmp.bitmap_bit_planes(fe.u32(qhi), fe.u32(qlo), bm.bits_log2)[0]
    lib_ms, _ = device_ms(lambda: bm.words[word_idx], reps)
    b2_ms, _ = device_ms(lambda: bmp.probe_bloom2(b2, qh1, ql1), reps)
    pb2_ms, _ = timed(lambda: bmp.probe_bloom2_ref(b2, qh1, ql1), reps)
    # the card's ceiling for B random word reads over 2^34 and 2^35 bits
    # (scripts/torch_probe_shapes.py's gather, 1-16 reads in flight a thread)
    import torch_probe_shapes

    ceiling = torch_probe_shapes.read_ceiling(bm.words, bits_list=(34, MAIN_BITS), reads=B,
                                              log=lambda m: None)
    ceil = {bits: min(row.values()) for bits, row in ceiling.items()}
    bms, by_ = bound_ms(12 * B, 40 * B + 12 * C1 + 4, clock)
    results["probe"] = dict(max_abs_err=err, ms=pr_ms, plain_ms=ppr_ms, bound_ms=bms,
                            bound_by=by_, library_ms=lib_ms)
    log(f"phase 3: level-1 stage B={B} against 2^{bm.bits_log2} bits (this chunk's queries, "
        f"{n1} pass, C1={C1}): fused probe_compact {pr_ms:.4f} ms against PR 6's composition "
        f"(mask {mask_ms:.4f} + count, compact_positions, gathers) {comp_ms:.4f} ms; the "
        f"card's random-read ceiling for {B} reads "
        + ", ".join(f"2^{bits} bits {ms:.4f} ms" for bits, ms in ceil.items())
        + f"; words[idx] {lib_ms:.4f} ms; plain {ppr_ms:.3f} ms; bound {bms:.4f} ms by {by_}")
    log(f"phase 3: bloom2 probe of the C1={C1} stage-1 survivors {b2_ms:.4f} ms (plain "
        f"{pb2_ms:.3f} ms); the cascade (filtered_survivors) {cas_ms:.4f} ms on the card; "
        f"through the fused probe equal to the plain probes' (max_abs_err 0)")
    del res, qhi, qlo, word_idx, got, want, ceiling
    arr = outs[2].cpu().numpy()
    t0 = time.perf_counter()
    for _ in range(reps):
        eng64._consume_summary(0, K, arr)
    dec_ms = (time.perf_counter() - t0) * 1000 / reps
    n_surv = int((arr[: eng64.C2] < K * U).sum())
    log(f"phase 3: chunk {tot_ms:.3f} ms on the card = K1 {k1_ms:.3f} + K2 {k2_ms:.3f} "
        f"+ cascade and summary {tot_ms - k1_ms - k2_ms:.3f}; host decode "
        f"{dec_ms:.3f} ms ({n_surv} survivors, C1={eng64.C1}, C2={eng64.C2})")
    chunk_split(eng64, px, py, "phase 3")
    chunk = lambda: chunk_impl_host(px, py, eng64.tab_x, eng64.tab_y, eng64.adv_x, eng64.adv_y,
                                    eng64.bitmap, eng64.bloom2, U=U, K=K, T=1, C1=eng64.C1,
                                    C2=eng64.C2, adv_tab=eng64.adv_tab, pair_tab=eng64.pair_tab)
    fig = chunk_before_after(eng64, px, py, chunk, "phase 3", PREV_SECONDS, lambda: BSGSEngine(
        [ecref.scalar_mult(PUZZLE64_KEY)], 1 << 63, 1 << 64, params, device=dev,
        host_table=htab, bitmap=eng.bitmap, bloom2=eng.bloom2))
    log(f"phase 3: keys/s before {fig['before']['keys_per_s']:.4e} (the torch route) and after "
        f"{keys_per_sec:.4e} (this phase's window)")
    # one streaming-build step (the first: its keys are in the filters
    # already, so the ORs change nothing), its device operations and time
    bwalk = pwalk.walk_tables(ecref.G, BUILD_BLOCK, ecref.scalar_mult(BUILD_BLOCK),
                              BUILD_BLOCKS, dev)
    bbase = ecref.scalar_mult(2 * BUILD_BLOCK)
    limbs = lambda v: torch.from_numpy(fe.int_to_limbs(v).view(np.int32).copy()).to(dev)
    bpx, bpy = limbs(bbase[0])[None], limbs(bbase[1])[None]
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    nb = BUILD_BLOCKS * BUILD_BLOCK
    step = lambda: filter_build_step(bpx, bpy, bwalk, bm.words, bm.bits_log2, b2.words,
                                     b2.bits_log2, nb, bad)
    w_before = (int(bm.words.sum()), int(b2.words.sum()))
    step()
    step_ops = device_launches(step)
    step_ms, _ = device_ms(step, reps)
    if int(bad) or (int(bm.words.sum()), int(b2.words.sum())) != w_before:
        fail("phase 3: the build step flagged a degenerate lane or changed the filters")
    log(f"phase 3: a streaming-build step ({nb} keys: K1, K2, K3 with its degeneracy "
        f"count) {step_ops or 'not measured: the profiler saw no'} device operations "
        f"(torch.profiler), {step_ms:.4f} ms on the card ({build_steps} steps in the build)")
    log(f"phase 3: device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated, {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak; "
        f"card {card_line()}")
    return n_main, htab, eng.bitmap, eng.bloom2


def phase3_m30(dev):
    """One host-resolve chunk at m = 2^30, the bench's headline shape
    (U = 16384, K = 256, 2^35 + 2^35-bit filters built on the card by the
    streaming build, as the bench builds them; no host table: a chunk reads
    only the two filters), held to its plain versions (chunk_composition)
    and split on the card by chunk_split; the engine's budgets are
    CASCADE_30."""
    import gc
    import types

    import torch

    from keyhuntm1cpu_tpu_torch.engine.bsgs import BSGSEngine
    from keyhuntm1cpu_tpu_torch.ref import ecref

    m = 1 << 30
    t0 = time.time()
    eng = BSGSEngine([ecref.scalar_mult(PUZZLE64_KEY)], *PUZZLE64_RANGE,
                     bsgs_params(m, "host"), device=dev, host_table=types.SimpleNamespace(m=m))
    torch.cuda.synchronize()
    t_build = time.time() - t0
    if (eng.C1, eng.C2) != CASCADE_30:
        fail(f"phase 3: m = 2^30's budgets are {(eng.C1, eng.C2)}, not {CASCADE_30}")
    px, py = eng._initial_base(0)
    got = eng._chunk_fn(px, py)[2]
    err = max_abs_err([got], [chunk_composition(eng, px, py, plain=True)[2]])
    if err:
        fail(f"phase 3: the m = 2^30 chunk differs from its plain versions (max_abs_err {err})")
    log(f"phase 3: m=2^30 host resolve: filters (2^{eng.bitmap.bits_log2} + "
        f"2^{eng.bloom2.bits_log2} bits) streamed on the card in {t_build:.2f} s; a chunk "
        f"equal to its plain versions (max_abs_err 0)")
    ms = chunk_split(eng, px, py, "phase 3 m=2^30")
    del eng, got
    gc.collect()
    torch.cuda.empty_cache()
    return ms


def phase4_brute(dev, seconds, clock, rates):
    """The brute-force path per mode; returns the throughput windows' launch
    counts, each window counted from zero; each mode's effective keys/s
    goes into `rates`."""
    import hashlib

    import torch

    from keyhuntm1cpu_tpu_torch.curve import pbrute, pwalk
    from keyhuntm1cpu_tpu_torch.engine.brute import BruteEngine, BruteParams
    from keyhuntm1cpu_tpu_torch.ref import ecref
    from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet

    kind = {"rmd160": "hash160", "xpoint": "xpoint", "eth": "eth", "address_u": "hash160"}
    total = None
    for name, mode, endo in (("rmd160", "rmd160", False), ("xpoint", "xpoint", False),
                             ("eth", "eth", False), ("address_u", "address_u", False),
                             ("rmd160 -e", "rmd160", True), ("rmd160 T=4096", "rmd160", False)):
        keys = list(range(1, 33))
        raw = [brute_artifact(mode, ecref.scalar_mult(k)) for k in keys]
        labels = [str(k) for k in keys]
        bucketed = name.endswith("4096")
        if bucketed:  # bench_modes.py's decoys
            raw += [hashlib.sha256(f"bench-decoy{i}".encode()).digest()[:20]
                    for i in range(4096 - len(keys))]
            labels += [f"d{i}" for i in range(4096 - len(keys))]
        ts = TargetSet(kind=kind[mode], raw=raw, labels=labels)
        t0 = time.time()
        gate = BruteParams(block_u=1024 if bucketed else 256, steps_per_chunk=4,
                           chunk_cand=64, endo=endo)
        eng = BruteEngine(ts, 1, 4097, mode=mode, params=gate, device=dev)
        if bucketed and not eng._bucketed:
            fail("T=4096 must take the bucketed path")
        got = sorted(f.private_key for f in eng.search())
        if got != keys:
            fail(f"brute {name} gate: found {got}, planted 1..32")
        t_gate = time.time() - t0

        params = BruteParams(block_u=U, steps_per_chunk=K, endo=endo)
        eng = BruteEngine(ts, *BRUTE_RANGE, mode=mode, params=params, device=dev)
        eng.search(max_steps=K)  # warm-up chunk
        marks, enqueue = marked(eng)
        cands = []
        ver = host_timed(eng, "_verify_all", cands)
        dec = host_timed(eng, "_decode_fast")
        reset_counts()
        k0 = eng.stats.keys_covered
        torch.cuda.synchronize()
        t0 = time.time()
        eng.search(max_seconds=seconds)
        torch.cuda.synchronize()
        dt = time.time() - t0
        _, n = launch_counts()
        chunks = (eng.stats.keys_covered - k0) // (K * U)
        if (n != zero_counts() | dict.fromkeys(("advance_chain", "brute_walk_blocks",
                                                "compact_hits"), len(marks))
                or chunks != len(marks)):
            fail(f"brute {name} launched {n} for {len(marks)} chunks dispatched, "
                 f"{chunks} counted")
        total = n if total is None else {k: total[k] + n[k] for k in n}
        eff = (eng.stats.keys_covered - k0) * eng.stats.multiplier / dt
        rates[name] = eff
        busy = sum(a.elapsed_time(b) for a, b in marks)
        span = marks[0][0].elapsed_time(marks[-1][1])
        enq_ms = 1000 * sum(enqueue) / len(marks)
        # chunk split on the card (device_ms): whole chunk, K1, K4 and the
        # compaction alone; the chunk's device operations (torch.profiler)
        px, py = eng._fast_base(0)

        def chunk():
            return pbrute.brute_chunk(
                px, py, eng.tab_x, eng.tab_y, eng.adv_x, eng.adv_y, eng._tgt, eng._btab,
                K=K, U=U, C=params.chunk_cand, mode=mode, n_endo=eng._n_endo,
                n_bucket_rows=eng._n_bucket_rows, adv_tab=eng.adv_tab)
        n_dev, n_memset = device_ops(chunk)
        c_ms, _ = device_ms(chunk, 5)
        k1_ms, (bx, by, _, _, adeg) = device_ms(lambda: pwalk.advance_chain(
            px[:, None], py[:, None], eng.adv_x, eng.adv_y, K, eng.adv_tab), 5)
        k4_ms, hits = device_ms(lambda: pbrute.brute_walk_blocks(
            bx, by, eng.tab_x, eng.tab_y, eng._tgt, eng._btab, mode, eng._n_endo,
            eng._n_bucket_rows), 5)
        cp_ms, _ = device_ms(lambda: pbrute.compact_hits(hits, adeg[0], params.chunk_cand), 20)
        n_tgt, tb = eng._tgt.shape[1], eng._n_bucket_rows
        k4_bound, _ = bound_ms(k4_ops(mode, eng._n_endo, n_tgt, tb, K * U),
                               64 * (K + U) + 16 * n_tgt + 512 * tb + 4 * K * U, clock)
        log(f"phase 4: {name}: gate keys 1..32 bit-exact in {t_gate:.1f} s; "
            f"{chunks} chunks in {dt:.2f} s -> {eff:.4e} effective keys/s "
            f"(x{eng.stats.multiplier}; K={K}, U={U}, T={len(raw)}, {tb} bucket rows); "
            f"idle share {1 - busy / span:.4f}; host enqueue {enq_ms:.3f} ms a chunk; "
            f"chunk {c_ms:.3f} ms on the card in "
            f"{n_dev or 'not measured: the profiler saw no'} device operations (kernels, "
            f"copies, fills; torch.profiler; {n_memset} memsets) = K1 {k1_ms:.3f} + K4 "
            f"{k4_ms:.3f} (bound "
            f"{k4_bound:.3f}) + compaction {cp_ms:.4f} (the rest "
            f"{c_ms - k1_ms - k4_ms - cp_ms:.4f}); host decode "
            f"{1000 * dec[0] / chunks:.3f} ms a chunk with {len(cands) / chunks:.4f} "
            f"candidates a chunk, each checked by one ecref scalar mult ("
            + (f"{1000 * ver[0] / len(cands):.3f} ms a candidate" if cands else "none")
            + f"); launches {n}")
        if bucketed:
            # the same window with the JAX engine's check (two scalar mults
            # a candidate) in place of the port's; not counted
            eng._verify = lambda k, row=0, pt=None: verify_two_mults(eng, k)
            marks.clear()
            cands.clear()
            dec[:] = ver[:] = [0.0, 0, 0]
            k0 = eng.stats.keys_covered
            torch.cuda.synchronize()
            t0 = time.time()
            eng.search(max_seconds=seconds)
            torch.cuda.synchronize()
            dt = time.time() - t0
            chunks = (eng.stats.keys_covered - k0) // (K * U)
            busy = sum(a.elapsed_time(b) for a, b in marks)
            span = marks[0][0].elapsed_time(marks[-1][1])
            log(f"phase 4: {name} with two ecref scalar mults a candidate (the JAX "
                f"engine's check), not counted: {chunks} chunks in {dt:.2f} s -> "
                f"{(eng.stats.keys_covered - k0) * eng.stats.multiplier / dt:.4e} effective "
                f"keys/s; idle share {1 - busy / span:.4f}; host decode "
                f"{1000 * dec[0] / chunks:.3f} ms a chunk with {len(cands) / chunks:.4f} "
                f"candidates a chunk ("
                + (f"{1000 * ver[0] / len(cands):.3f} ms a candidate" if cands else "none") + ")")
    return total


def phase4b_minikeys(dev, seconds):
    """The minikeys path; returns the throughput windows' launch counts, each
    window counted from zero."""
    import hashlib

    import torch

    from keyhuntm1cpu_tpu_torch.curve import pladder
    from keyhuntm1cpu_tpu_torch.engine import minikeys as mk
    from keyhuntm1cpu_tpu_torch.hash import phash, pminikey
    from keyhuntm1cpu_tpu_torch.ref import ecref, hashref
    from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet

    # the bench gate: the first valid minikey of the prefix, found in one chunk
    for c in range(1 << 18):
        s_ = MK_PREFIX + mk._b58_digits(c // mk.LOW_SPAN, 5) + mk._b58_digits(c % mk.LOW_SPAN, 5)
        if hashlib.sha256((s_ + "?").encode()).digest()[0] == 0:
            break
    key = int.from_bytes(hashlib.sha256(s_.encode()).digest(), "big")
    target = hashref.pubkey_to_hash160(ecref.scalar_mult(key), compressed=False)
    params = mk.tuned_params(batch=MK_BATCH)  # the card's: tuned_params(device="cuda")
    B, V = params.batch, params.valid_max
    t0 = time.time()
    eng = mk.MinikeyEngine(TargetSet(kind="hash160", raw=[target], labels=["planted"]),
                           prefix=MK_PREFIX, params=params, device=dev)
    found = eng.search(max_chunks=1)
    if [f.private_key for f in found] != [key] or s_ not in found[0].target:
        fail(f"minikeys gate: found {found}, planted {s_}")
    log(f"phase 4b: minikeys gate: planted minikey {s_} (counter {c}) recovered bit-exact "
        f"in one chunk of {B} in {time.time() - t0:.1f} s")

    total = None
    for name, n_decoys in (("1 target", 0), (f"{MK_DECOYS} targets", MK_DECOYS)):
        raw = [target] + [hashlib.sha256(b"mk-decoy%d" % i).digest()[:20]
                          for i in range(n_decoys)]
        t0 = time.time()
        eng = mk.MinikeyEngine(TargetSet(kind="hash160", raw=raw, labels=["planted"] * len(raw)),
                               prefix=MK_PREFIX, params=params, device=dev)
        t_setup = time.time() - t0
        eng.counter = MK_COUNTER
        eng.search(max_chunks=1, stop_on_first=False)  # warm-up chunk
        chunk_fn = eng._chunk_fn
        marks, enqueue = marked(eng)
        reset_counts()
        k0 = eng.stats.keys_covered
        torch.cuda.synchronize()
        t0 = time.time()
        eng.search(max_seconds=seconds, stop_on_first=False)
        torch.cuda.synchronize()
        dt = time.time() - t0
        _, n = launch_counts()
        chunks = (eng.stats.keys_covered - k0) // B
        mk_names = ("minikey_valid", "minikey_compact_keys", "scalar_mult", "hash160_x2",
                    "hash160_u")
        if n != zero_counts() | dict.fromkeys(mk_names, len(marks)) or chunks != len(marks):
            fail(f"minikeys {name} launched {n} for {len(marks)} chunks dispatched, "
                 f"{chunks} counted")
        total = n if total is None else {k: total[k] + n[k] for k in n}
        rate = (eng.stats.keys_covered - k0) / dt
        busy = sum(a.elapsed_time(b) for a, b in marks)
        span = marks[0][0].elapsed_time(marks[-1][1])
        enq_ms = 1000 * sum(enqueue) / chunks

        # chunk split by CUDA events at this engine's shapes
        low, _, w22, w23 = minikey_bases(eng, mk._B58, MK_COUNTER)
        reps = 20
        c_ms, _ = timed(lambda: chunk_fn(low, w22, w23), reps)
        n_dev = device_launches(lambda: chunk_fn(low, w22, w23))
        k5_ms, valid = timed(lambda: pminikey.minikey_valid(low, w23, B, mk._B58), reps)
        ck_ms, (_, _, k) = timed(lambda: pminikey.compact_keys(valid, V, low, w22, B, mk._B58),
                                 reps)
        ck_dev, _ = device_ms(lambda: pminikey.compact_keys(valid, V, low, w22, B, mk._B58),
                              reps)
        k6_ms, pt = timed(lambda: pladder.scalar_mult_tiles(k, eng._gx, eng._gy), reps)
        h_ms, _ = timed(lambda: (phash.hash160_x2_from_batch(pt[0]),
                                 phash.hash160_u_from_batch(pt[0], pt[1])), reps)
        rest = c_ms - k5_ms - ck_ms - k6_ms - h_ms
        log(f"phase 4b: minikeys, {name} (table set-up {t_setup:.1f} s): {chunks} chunks in "
            f"{dt:.2f} s -> {rate:.4e} minikeys/s (B={B}, V={V}); idle share "
            f"{1 - busy / span:.4f} (busy {busy / chunks:.3f} ms per chunk, host enqueue "
            f"{enq_ms:.3f} ms); chunk {c_ms:.3f} ms in "
            f"{n_dev or 'not measured: the profiler saw no'} device operations (torch.profiler) "
            f"= K5 {k5_ms:.3f} + compaction and keys {ck_ms:.4f} (the card's time alone "
            f"{ck_dev:.4f}) + K6 {k6_ms:.3f} + K7+K8 "
            f"{h_ms:.3f} + lookup and summary {rest:.3f}; launches {n}")
    return total


def phase4c_walker(dev, seconds):
    """The large-target brute path; returns the throughput windows' launch
    counts, each window counted from zero."""
    import tempfile

    import numpy as np
    import torch

    from keyhuntm1cpu_tpu_torch.curve import walk
    from keyhuntm1cpu_tpu_torch.engine.brute import BruteEngine, BruteParams
    from keyhuntm1cpu_tpu_torch.field import pinv
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp
    from keyhuntm1cpu_tpu_torch.filter import sorted_table as st
    from keyhuntm1cpu_tpu_torch.ref import ecref
    from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet, parse_target_file

    kind = {"xpoint": "xpoint", "eth": "eth"}
    lam, lam2 = ecref.LAMBDA, ecref.LAMBDA * ecref.LAMBDA % ecref.N
    for name, mode, endo in (("rmd160", "rmd160", False), ("xpoint", "xpoint", False),
                             ("eth", "eth", False), ("address_u", "address_u", False),
                             ("rmd160_both", "rmd160_both", False),
                             ("rmd160 -e", "rmd160", True), ("xpoint -e", "xpoint", True)):
        keys = list(range(1, 33)) + ([lam * 5 % ecref.N, lam2 * 600 % ecref.N] if endo else [])
        ts = TargetSet(kind=kind.get(mode, "hash160"), labels=[str(k) for k in keys],
                       raw=[brute_artifact(mode, ecref.scalar_mult(k)) for k in keys])
        gate = BruteParams(walkers=2, block_u=256, steps_per_chunk=4, compare_max=0,
                           bucket_max=0, endo=endo)
        t0 = time.time()
        eng = BruteEngine(ts, 1, 4097, mode=mode, params=gate, device=dev)
        got = sorted(f.private_key for f in eng.search())
        if not eng._walker or got != sorted(keys):
            fail(f"walker gate {name}: found {got}, planted {sorted(keys)}")
        log(f"phase 4c: walker gate {name}: keys 1..32{' and lambda*5, lambda^2*600' if endo else ''} "
            f"bit-exact over [1, 4097) in {time.time() - t0:.1f} s")

    W, U, K, L = WK_W, WK_U, WK_K, WK_L
    a, b = BRUTE_RANGE
    window = 2 * U + 1
    slice_len = -(-(b - a) // W)  # each walker's slice, in whole windows
    slice_len = -(-slice_len // window) * window
    # 32 planted keys in the first chunk of walkers 0 and 7: (step, window offset)
    spots = [(0, 0), (0, U), (0, 2 * U), (1, 1), (2, 100), (3, U - 1), (3, 5000), (4, 2),
             (5, 8000), (5, U + 1), (6, 77), (6, 6000), (7, 3), (7, U), (7, 2 * U - 1),
             (7, 2 * U)]
    planted = sorted({a + w * slice_len + s % K * window + o % window
                      for w in (0, W - 1) for s, o in spots})
    rng = np.random.default_rng(43)
    decoys = rng.integers(0, 256, (WK_T - len(planted), 20), dtype=np.uint8).tobytes().hex()
    decoys = [decoys[i:i + 40] for i in range(0, len(decoys), 40)]
    params = BruteParams(walkers=W, block_u=U, steps_per_chunk=K, chain_len=L, cand_max=256)
    total = None
    for mode in ("rmd160", "eth"):
        art = [brute_artifact(mode, ecref.scalar_mult(k)).hex() for k in planted]
        lines = ([f"0x{h}" for h in art + decoys] if mode == "eth" else art + decoys)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "targets.txt")
            with open(path, "w") as f:
                f.write("\n".join(lines) + "\n")
            t0 = time.time()
            ts = parse_target_file(path, "eth" if mode == "eth" else "rmd160")
            t_parse = time.time() - t0
        del lines
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        ts.build_table(dev)
        torch.cuda.synchronize()
        t_table = time.time() - t0
        t0 = time.time()
        card_bm = ts.build_bitmap(device=dev)
        torch.cuda.synchronize()
        t_bitmap = time.time() - t0
        if mode == "rmd160":  # once, outside the timed set-up: word for word the host build
            t0 = time.time()
            lo, hi = ts.target_words()
            host_bm = bmp.build_bitmap(hi, lo, WK_BITS)
            t_host = time.time() - t0
            same = torch.equal(host_bm.words.to(dev), card_bm.words)
            del host_bm
            if not same or card_bm.bits_log2 != WK_BITS:
                fail(f"the card-built 2^{WK_BITS}-bit bitmap differs from the host build")
            log(f"phase 4c: the card-built bitmap of {WK_T} targets (2^{WK_BITS} bits, K3 "
                f"from the uploaded keys) equals the host build (numpy, {t_host:.2f} s) word "
                f"for word")
        del card_bm
        t0 = time.time()
        eng = BruteEngine(ts, a, b, mode=mode, params=params, device=dev)
        t_engine = time.time() - t0
        if not eng._walker or eng.bitmap.bits_log2 != WK_BITS or eng.slice_len != slice_len:
            fail(f"T = {WK_T} must take the walker path with a 2^{WK_BITS}-bit bitmap")
        t0 = time.time()
        got = sorted(f.private_key for f in eng.search(max_steps=K))
        if got != planted:
            fail(f"walker {mode} T={WK_T}: found {len(got)} keys, planted {len(planted)}")
        t_gate = time.time() - t0

        marks, enqueue = marked(eng)
        reset_counts()
        k0 = eng.stats.keys_covered
        torch.cuda.synchronize()
        t0 = time.time()
        eng.search(max_seconds=seconds)
        torch.cuda.synchronize()
        dt = time.time() - t0
        _, n = launch_counts()
        chunks = (eng.stats.keys_covered - k0) // (K * W * window)
        steps = K * len(marks)
        hashed = {"rmd160": "hash160_x2", "eth": "keccak_eth"}[mode]
        want = zero_counts() | {k: steps for k in ("walk_prefix", "inv_batch", "walk_emit",
                                                   "probe", hashed, "lookup_summary")}
        if n != want or chunks != len(marks):
            fail(f"walker {mode} launched {n} for {len(marks)} chunks dispatched, "
                 f"{chunks} counted")
        total = n if total is None else {k: total[k] + n[k] for k in n}
        eff = (eng.stats.keys_covered - k0) * eng.stats.multiplier / dt
        busy = sum(e0.elapsed_time(e1) for e0, e1 in marks)
        span = marks[0][0].elapsed_time(marks[-1][1])
        enq_ms = 1000 * sum(enqueue) / len(marks)
        peak = torch.cuda.max_memory_allocated() / 2**30

        # the card's own work per chunk (device_ms), each piece K times
        reps = 10
        ctr = eng._centers_for_bases(eng._sequential_bases(0))
        args = (ctr.x, ctr.y, eng.tab_x, eng.tab_y, eng.adv_x, eng.adv_y)
        need_y = mode == "eth"
        n_dev = device_launches(lambda: eng._walker_chunk(ctr.x, ctr.y))
        # 2 chunks, within the stream's queue of pending work
        c_ms, _ = device_ms(lambda: eng._walker_chunk(ctr.x, ctr.y), 2)
        p_ms, (pre, tot) = device_ms(lambda: walk.walk_prefix(*args, L), reps)
        i_ms, itot = device_ms(lambda: pinv.inv_batch(tot), reps)
        e_ms, _ = device_ms(lambda: walk.walk_emit(*args, pre, itot, L, 1, need_y), reps)
        res = walk.walk_fused(ctr, *args[2:], need_y=need_y, chain_len=L)
        h_ms, (qhi, qlo) = device_ms(lambda: eng._queries(res), reps)
        pr_ms, pc = device_ms(lambda: bmp.probe_compact(eng.bitmap, qhi, qlo, params.cand_max),
                              reps)
        n_query = eng.n_qsets * W * window
        lk_ms, _ = device_ms(lambda: st.lookup_summary(eng.table, *pc, res.degenerate,
                                                       res.adv_degenerate, n_query), reps)
        rest = c_ms - K * (p_ms + i_ms + e_ms + h_ms + pr_ms + lk_ms)
        log(f"phase 4c: walker {mode} T={WK_T} (bitmap 2^{WK_BITS} bits, table "
            f"{(eng.table.key.numel() * 12) / 2**20:.0f} MiB): set-up parse {t_parse:.1f} s, "
            f"table {t_table:.2f} s, bitmap {t_bitmap:.2f} s, engine {t_engine:.1f} s; "
            f"32 planted keys bit-exact in one chunk ({t_gate:.2f} s)")
        wall = 1000 * dt / len(marks)
        log(f"phase 4c: walker {mode}: {len(marks)} chunks in {dt:.2f} s -> {eff:.4e} "
            f"effective keys/s (x{eng.stats.multiplier}; W={W}, U={U}, K={K}, L={L}); idle "
            f"share {1 - busy / span:.4f} between chunk events (busy {busy / len(marks):.3f} "
            f"ms per chunk, host enqueue {enq_ms:.3f} ms per chunk); the card's work per "
            f"chunk {c_ms:.3f} ms of {wall:.3f} ms wall (idle {1 - c_ms / wall:.4f}) in "
            f"{n_dev or 'not measured: the profiler saw no'} device operations (kernels, "
            f"copies, fills; torch.profiler) = K x "
            f"(walk_prefix {p_ms:.4f} + pinv {i_ms:.4f} + walk_emit {e_ms:.4f} + hash "
            f"{h_ms:.4f} + probe and compaction {pr_ms:.4f} + lookup and summary "
            f"{lk_ms:.4f}) + the rest {rest:.3f}; device memory "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak {peak:.2f} GiB; "
            f"launches {n}")
        del res, pre, tot, itot, qhi, qlo, pc
        if mode == "rmd160":
            walker_resume(ts, a, b, params, dev, planted)
        del eng, ts
        torch.cuda.empty_cache()
    return total


def verify_two_mults(eng, k, row=0, pt=None):
    """The JAX engine's host check of a candidate (engine/brute.py:763-789):
    a scalar mult for k, then another for N - k."""
    from keyhuntm1cpu_tpu_torch.engine.common import FoundKey
    from keyhuntm1cpu_tpu_torch.ref import ecref, hashref

    for cand in (k, ecref.N - (k % ecref.N)):
        if not 1 <= cand < ecref.N:
            continue
        p = ecref.scalar_mult(cand)
        for got, compressed in eng._artifacts(p):
            i = eng._raw_index.get(got)
            if i is not None:
                return FoundKey(private_key=cand, pubkey=p, compressed=compressed,
                                target=eng.targets.labels[i])
            if eng.prefixes and eng.mode != "xpoint":
                addr = hashref.b58check_encode(b"\x00" + got)
                if any(addr.startswith(pref) for pref in eng.prefixes):
                    return FoundKey(private_key=cand, pubkey=p, compressed=compressed,
                                    target=addr)
    return None


def prefix_keys(prefix, n):
    """The keys a compressed-address prefix scan of [1, n + 1) reports, by
    the JAX engine's rule (k if its address has the prefix, else N - k if
    that one's has): {k: reported key}, on the host."""
    from keyhuntm1cpu_tpu_torch.ref import ecref, hashref

    out, pt = {}, ecref.G
    for k in range(1, n + 1):
        for key, p in ((k, pt), (ecref.N - k, ecref.point_neg(pt))):
            if hashref.pubkey_to_address(p).startswith(prefix):
                out[k] = key
                break
        pt = ecref.point_add(pt, ecref.G)
    return out


def phase4v_vanity(dev, seconds):
    """Vanity (bench_modes.bench_vanity's protocol): the gate over [1, 2049)
    at U = 256, K = 4, -v beside phase 4's 32 targets, then `seconds` of
    throughput at U = 16384, K = 256; returns the window's launch counts."""
    import torch

    from keyhuntm1cpu_tpu_torch.curve import pbrute, pladder
    from keyhuntm1cpu_tpu_torch.engine.brute import BruteEngine, BruteParams
    from keyhuntm1cpu_tpu_torch.engine.vanity import vanity_intervals
    from keyhuntm1cpu_tpu_torch.ref import ecref, hashref
    from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet

    prefix = hashref.pubkey_to_address(ecref.scalar_mult(777))[:5]
    ivs = vanity_intervals(prefix)
    empty = TargetSet(kind="hash160", raw=[], labels=[])
    t0 = time.time()
    ref = prefix_keys(prefix, 4096)
    t_ref = time.time() - t0
    gate = BruteParams(block_u=256, steps_per_chunk=4, chunk_cand=64)
    t0 = time.time()
    eng = BruteEngine(empty, 1, 2049, mode="rmd160", params=gate, device=dev, intervals=ivs,
                      prefixes=[prefix])
    found = eng.search()
    want = sorted(v for k, v in ref.items() if k < 2049)
    if 777 not in want or sorted(f.private_key for f in found) != want:
        fail(f"vanity gate {prefix}: found {sorted(f.private_key for f in found)}, want {want}")
    t_gate = time.time() - t0
    keys = list(range(1, 33))
    ts = TargetSet(kind="hash160", labels=[str(k) for k in keys],
                   raw=[brute_artifact("rmd160", ecref.scalar_mult(k)) for k in keys])
    eng = BruteEngine(ts, 1, 4097, mode="rmd160", params=gate, device=dev, intervals=ivs,
                      prefixes=[prefix])
    got = sorted(f.private_key for f in eng.search())
    if got != sorted(set(keys) | set(ref.values())):
        fail(f"-v {prefix} beside keys 1..32: found {got}")
    log(f"phase 4v: vanity gate: prefix {prefix} ({len(ivs)} intervals) over [1, 2049): "
        f"{len(want)} keys, key 777 among them, bit-exact in {t_gate:.1f} s (the host's "
        f"reference scan of 4096 keys {t_ref:.1f} s); -v {prefix} beside keys 1..32 over "
        f"[1, 4097): all {len(got)} keys")

    params = BruteParams(block_u=U, steps_per_chunk=K)
    eng = BruteEngine(empty, *BRUTE_RANGE, mode="rmd160", params=params, device=dev,
                      intervals=ivs, prefixes=[prefix])
    eng.search(max_steps=K)  # warm-up chunk
    marks, enqueue = marked(eng)
    cands = []
    ver = host_timed(eng, "_verify_all", cands)
    dec = host_timed(eng, "_decode_fast")
    k6 = host_timed(pladder, "scalar_mult_points")  # the batch's round trip
    reset_counts()
    k0 = eng.stats.keys_covered
    torch.cuda.synchronize()
    t0 = time.time()
    found = eng.search(max_seconds=seconds)
    torch.cuda.synchronize()
    dt = time.time() - t0
    _, n = launch_counts()
    pladder.scalar_mult_points = pladder.scalar_mult_points.__wrapped__
    chunks = (eng.stats.keys_covered - k0) // (K * U)
    want = zero_counts() | dict.fromkeys(("advance_chain", "brute_walk_blocks", "compact_hits"),
                                         len(marks)) | dict(scalar_mult=ver[2])
    if n != want or chunks != len(marks):
        fail(f"vanity launched {n} for {len(marks)} chunks dispatched, {chunks} counted, "
             f"{ver[2]} verify batches")
    for f in found[:16] + found[-16:]:  # reported keys' addresses, computed again
        if (f.target != hashref.pubkey_to_address(ecref.scalar_mult(f.private_key))
                or not f.target.startswith(prefix)):
            fail(f"vanity window reported {f.private_key:x} -> {f.target}")
    eff = (eng.stats.keys_covered - k0) * eng.stats.multiplier / dt
    busy = sum(a.elapsed_time(b) for a, b in marks)
    span = marks[0][0].elapsed_time(marks[-1][1])
    px, py = eng._fast_base(0)
    c_ms, _ = device_ms(lambda: pbrute.brute_chunk(
        px, py, eng.tab_x, eng.tab_y, eng.adv_x, eng.adv_y, eng._tgt, eng._btab, K=K, U=U,
        C=params.chunk_cand, mode="rmd160", n_endo=1, adv_tab=eng.adv_tab), 5)
    # the host check without the batch: two ecref scalar mults a candidate
    # (the JAX engine's), and one (k and its negation)
    sample = cands[:16]
    t = time.perf_counter()
    for k in sample:
        verify_two_mults(eng, k)
    two_ms = 1000 * (time.perf_counter() - t) / max(1, len(sample))
    t = time.perf_counter()
    for k in sample:
        eng._verify(k)
    one_ms = 1000 * (time.perf_counter() - t) / max(1, len(sample))
    per = len(cands) / chunks
    log(f"phase 4v: vanity {prefix}: {chunks} chunks in {dt:.2f} s -> {eff:.4e} effective "
        f"keys/s (x{eng.stats.multiplier}; K={K}, U={U}, {len(ivs)} intervals); {len(found)} "
        f"keys found, {per:.2f} candidates a chunk, each address checked again; idle share "
        f"{1 - busy / span:.4f} (busy {busy / chunks:.3f} ms per chunk); the card's chunk "
        f"{c_ms:.3f} ms (device_ms); host a chunk: enqueue {1000 * sum(enqueue) / chunks:.3f} "
        f"ms, decode {1000 * dec[0] / chunks:.3f} ms of which the check {1000 * ver[0] / chunks:.3f} "
        f"ms ({ver[2]} K6 batches on the check's stream, {1000 * ver[0] / max(1, ver[2]):.3f} "
        f"ms each, of which K6's round trip {1000 * k6[0] / max(1, k6[1]):.3f} ms and the "
        f"addresses on the host the rest); the check without the batch: two ecref scalar mults a candidate (the "
        f"JAX engine's) {two_ms:.3f} ms = {two_ms * per:.3f} ms a chunk, one {one_ms:.3f} ms = "
        f"{one_ms * per:.3f} ms a chunk; launches {n}")
    return n


def phase3s_scheduled(dev, m, seconds, htab, bm, b2):
    """Scheduled BSGS on phase 3's table and filters: kill and resume of a
    random order (puzzle 63's chunk in the order's second half), then
    `seconds` of -B random and of -B sequential over the puzzle-64 range;
    returns the two windows' launch counts."""
    import tempfile

    import torch

    from keyhuntm1cpu_tpu_torch.core.checkpoint import CheckpointManager
    from keyhuntm1cpu_tpu_torch.engine.bsgs import BSGSEngine
    from keyhuntm1cpu_tpu_torch.ref import ecref

    params = bsgs_params(m, "host")
    span = K * U * 2 * m  # keys a chunk
    n_ck, pos = 8, 5
    a = PUZZLE63_KEY - pos * span - 12345
    pub63 = ecref.scalar_mult(PUZZLE63_KEY)

    def engine(pub, a, b):
        return BSGSEngine([pub], a, b, params, device=dev, host_table=htab, bitmap=bm,
                          bloom2=b2)

    eng = engine(pub63, a, a + n_ck * span)
    seed = next(s for s in range(1000) if eng.chunk_order("random", s).index(pos) >= n_ck // 2)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(os.path.join(tmp, "ck.json"), every_s=0)
        first = eng.search_scheduled("random", seed, max_chunks=n_ck // 2, stop_on_first=False,
                                     checkpoint=mgr)
        eng2 = engine(pub63, a, a + n_ck * span)
        found = eng2.search_scheduled("random", seed, stop_on_first=False, checkpoint=mgr)
        ck = mgr.load()
    if (first or [f.private_key for f in found] != [PUZZLE63_KEY] or ck.chunks_done != n_ck
            or ck.keys_covered != n_ck * span or eng2.stats.keys_covered != n_ck * span):
        fail(f"scheduled kill and resume: first run {first}, resumed {found}, checkpoint "
             f"{ck.chunks_done} chunks {ck.keys_covered} keys")
    log(f"phase 3s: -B random (seed {seed}) over {n_ck} chunks, puzzle 63's at place "
        f"{eng.chunk_order('random', seed).index(pos)} of the order: {n_ck // 2} chunks, then "
        f"a fresh engine resumed from the checkpoint found the key once, {ck.chunks_done} "
        f"chunks and {ck.keys_covered} keys covered exactly ({time.time() - t0:.1f} s)")

    total = None
    pub64 = ecref.scalar_mult(PUZZLE64_KEY)
    for policy in ("random", "sequential"):
        eng = engine(pub64, *PUZZLE64_RANGE)
        t = time.perf_counter()
        for c in eng.chunk_order(policy, 1)[:8]:  # the rebase by one scalar mult
            eng._initial_base(c * K)
        init_ms = 1000 * (time.perf_counter() - t) / 8
        eng._scheduled_bases([1])  # its host table, built once per engine
        marks, enqueue = marked(eng)
        reb = host_timed(eng, "_scheduled_bases")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        found = eng.search_scheduled(policy, seed=1, stop_on_first=False, max_seconds=seconds)
        torch.cuda.synchronize()
        dt = time.time() - t0
        _, n = launch_counts()
        chunks = eng.stats.keys_covered // span
        if n != chunk_launches(eng, len(marks)) or chunks != len(marks):
            fail(f"-B {policy} launched {n} for {len(marks)} chunks dispatched, {chunks} "
                 "counted")
        if any(f.private_key != PUZZLE64_KEY for f in found):
            fail(f"-B {policy} found a wrong key: {[hex(f.private_key) for f in found]}")
        total = n if total is None else {k: total[k] + n[k] for k in n}
        busy = sum(e0.elapsed_time(e1) for e0, e1 in marks)
        span_ms = marks[0][0].elapsed_time(marks[-1][1])
        log(f"phase 3s: -B {policy}: {chunks} chunks in {dt:.2f} s -> "
            f"{eng.stats.keys_covered / dt:.4e} keys/s; idle share {1 - busy / span_ms:.4f} "
            f"(busy {busy / chunks:.3f} ms per chunk); host a chunk: enqueue "
            f"{1000 * sum(enqueue) / chunks:.3f} ms, rebase {1000 * reb[0] / chunks:.3f} ms "
            f"({reb[1]} host-table batches; _initial_base, a scalar mult a chunk: "
            f"{init_ms:.3f} ms a chunk); puzzle 64's key "
            f"{'found bit-exact' if found else 'not reached'}; launches {n}")
    return total


def phase_t16(dev, m, label, seconds, **shared):
    """bench_modes.bench_bsgs_multitarget on the phase's table and filters:
    the gate (16 planted keys in one 8-step window, all recovered), then
    `seconds` at K = 32, T = 16 over the puzzle-64 range (keys/s counts the
    range covered, as bench_modes.py does); returns the window's launch
    counts."""
    import dataclasses

    import numpy as np
    import torch

    from keyhuntm1cpu_tpu_torch.engine.bsgs import BSGSEngine
    from keyhuntm1cpu_tpu_torch.ref import ecref

    params = bsgs_params(m, shared.pop("resolve"))
    gate = dataclasses.replace(params, steps_per_chunk=8)
    a = 1 << 63
    window = gate.steps_per_chunk * U * 2 * m
    rng = np.random.default_rng(16)
    planted = sorted(a + int(v) for v in rng.integers(0, min(window, 1 << 63), size=16))
    t0 = time.time()
    eng = BSGSEngine([ecref.scalar_mult(k) for k in planted], a, a + window, gate, device=dev,
                     **shared)
    got = sorted(f.private_key for f in eng.search(stop_on_first=False, max_steps=8))
    if got != planted:
        fail(f"{label}: bsgs_t16 gate missed {[hex(k) for k in planted if k not in got]}")
    log(f"{label}: bsgs_t16 gate: 16 planted keys in one 8-step window recovered bit-exact "
        f"({time.time() - t0:.2f} s)")

    params = dataclasses.replace(params, steps_per_chunk=32)
    pubs = [ecref.scalar_mult(0x1000 + 7 * i) for i in range(16)]
    eng = BSGSEngine(pubs, *PUZZLE64_RANGE, params, device=dev, **shared)
    marks, enqueue = marked(eng)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    found = eng.search(max_seconds=seconds, stop_on_first=False)
    torch.cuda.synchronize()
    dt = time.time() - t0
    _, n = launch_counts()
    chunks = eng.stats.keys_covered // (32 * U * eng.stride)
    if found or chunks != len(marks) or n != chunk_launches(eng, chunks):
        fail(f"{label}: bsgs_t16 window found {found}, launched {n} for {len(marks)} chunks "
             f"dispatched, {chunks} counted")
    busy = sum(e0.elapsed_time(e1) for e0, e1 in marks)
    span = marks[0][0].elapsed_time(marks[-1][1])
    log(f"{label}: bsgs_t16 T=16 K=32: {chunks} chunks in {dt:.2f} s -> "
        f"{eng.stats.keys_covered / dt:.4e} range keys/s (C1={eng.C1}, C2={eng.C2}); idle "
        f"share {1 - busy / span:.4f} (busy {busy / chunks:.3f} ms per chunk); host enqueue "
        f"{1000 * sum(enqueue) / chunks:.3f} ms per chunk; launches {n}")
    return n


def chunk_split(eng, px, py, label):
    """One chunk of `eng` (either resolve mode) on the card by device_ms,
    whole and stage by stage on this chunk's own data: K1, K2 with the
    level-1 probe, the compaction of its mask (kh_mask_compact), the bloom2
    stage (kh_bloom2_compact, where the engine has a bloom2) and the summary
    (kh_bsgs_summary); logged with the survivors against C1 and C2, and
    beside K2 alone and kh_probe_compact, the pair the chunk ran before.
    Returns {stage: ms}."""
    from keyhuntm1cpu_tpu_torch.curve import pwalk
    from keyhuntm1cpu_tpu_torch.engine import bsgs
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp

    reps, Kc = 10, eng.p.steps_per_chunk
    B = len(eng.targets) * Kc * U
    ms = {"chunk": device_ms(lambda: eng._chunk_fn(px, py), reps)[0]}
    pxt, pyt = px.t().contiguous(), py.t().contiguous()
    pt = eng.pair_tab  # the paired walk: K1 with the centres, K2 over pairs
    ms["K1"], (bx, by, _, _, adeg, *centres) = device_ms(lambda: pwalk.advance_chain(
        pxt, pyt, eng.adv_x, eng.adv_y, Kc, eng.adv_tab, pt and pt[2:]), reps)
    pairs = (*pt[:2], *centres) if pt else None
    ms["K2"], (qlo, qhi, deg, mask) = device_ms(lambda: pwalk.walk_blocks(
        bx, by, eng.tab_x, eng.tab_y, eng.bitmap, pairs), reps)
    qhi, qlo, adv = qhi.reshape(-1), qlo.reshape(-1), adeg.reshape(-1)
    ms["mask compaction"], s1 = device_ms(lambda: bmp.mask_compact(mask, qhi, qlo, eng.C1),
                                          reps)
    fs, n2 = s1, None
    if eng.bloom2 is not None:
        ms["bloom2 stage"], fs = device_ms(lambda: bmp.bloom2_compact(eng.bloom2, s1, B,
                                                                      eng.C2), reps)
        n2 = int(fs.n)
    if eng.table is None:
        summary = lambda: bsgs.chunk_summary_host(*fs, deg, adv, (deg, adv))
    else:
        summary = lambda: bsgs.chunk_summary(eng.table, *fs, deg, adv, (deg, adv))
    ms["summary"], _ = device_ms(summary, reps)
    rest = ms["chunk"] - sum(v for k, v in ms.items() if k != "chunk")
    alone, _ = device_ms(lambda: pwalk.walk_blocks(bx, by, eng.tab_x, eng.tab_y, None, pairs),
                         reps)
    probe, _ = device_ms(lambda: bmp.probe_compact(eng.bitmap, qhi, qlo, eng.C1), reps)
    log(f"{label}: a chunk {ms['chunk']:.4f} ms on the card = "
        + " + ".join(f"{k} {v:.4f}" for k, v in ms.items() if k != "chunk")
        + f" (+ {rest:.4f} between them); {int(s1.n)} level-1 survivors of {B} (C1={eng.C1})"
        + (f", {n2} after the bloom2 (C2={eng.C2})" if n2 is not None else "")
        + f"; K2 alone {alone:.4f} ms + kh_probe_compact {probe:.4f} ms before the fusion")
    return ms | {"K2 alone": alone, "probe_compact": probe}


def chunk_composition(eng, px, py, plain=False):
    """One chunk of `eng` (either resolve mode) composed as chunk_impl and
    chunk_impl_host composed it before the cascade's kernels, which is how
    filtered_lookup / filtered_survivors and _pallas_chunk_impl(_host)
    compose it: K1, K2, the fused level-1 probe, then torch ops: the lane
    U - 1 fix-up, the bloom2 probe (kh_probe's bloom2 form), its mask,
    count and compact_positions, the clamps and gathers, the exact search
    (sorted_table.lookup), the live mask and the packing. plain: K1, K2 and
    the probes through their plain versions (the reference the chunk's
    kernels are held to). Returns (next_x, next_y, summary); next_x and
    next_y are None when plain."""
    import torch

    from keyhuntm1cpu_tpu_torch.curve import pwalk
    from keyhuntm1cpu_tpu_torch.engine.bsgs import _chunk_walk
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp
    from keyhuntm1cpu_tpu_torch.filter import sorted_table as st

    Kc, T = eng.p.steps_per_chunk, len(eng.targets)
    B, C1, C2 = T * Kc * U, eng.C1, eng.C2
    if plain:
        bx, by, _, _, adeg = pwalk.advance_chain_ref(px.t().contiguous(), py.t().contiguous(),
                                                     eng.adv_x, eng.adv_y, Kc, eng.adv_tab)
        qlo, qhi, deg = pwalk.walk_blocks_ref(bx, by, eng.tab_x, eng.tab_y)
        adv, nxt = adeg.reshape(-1), (None, None)
        level1, probe2 = bmp.probe_compact_ref, bmp.probe_bloom2_ref
    else:
        res, deg, adv = _chunk_walk(px, py, eng.tab_x, eng.tab_y, eng.adv_x, eng.adv_y, U, Kc,
                                    T, eng.adv_tab, pair_tab=eng.pair_tab)
        qhi, qlo, nxt = res.qhi, res.qlo, (res.next_x, res.next_y)
        level1, probe2 = bmp.probe_compact, bmp.probe_bloom2
    deg[:, U - 1] |= adv
    pos1, qh1, ql1, n1 = level1(eng.bitmap, qhi.reshape(-1), qlo.reshape(-1), C1)
    if eng.bloom2 is None:
        pos, qh, ql, n = pos1, qh1, ql1, n1
    else:
        mask2 = probe2(eng.bloom2, qh1, ql1) & (pos1 < B)
        pos2 = bmp.compact_positions(mask2, C2, C1)
        safe2 = pos2.clamp(max=C1 - 1).long()
        pos = torch.where(pos2 < C1, pos1[safe2], B)
        qh, ql = qh1[safe2], ql1[safe2]
        n = torch.where(n1 > C1, n1 + C2, mask2.sum(dtype=torch.int32))
    live = (pos < B) & ~deg.reshape(-1)[pos.clamp(max=B - 1).long()]
    if eng.table is None:
        words = [torch.where(live, pos, B), qh, ql]
    else:
        lr = st.lookup(eng.table, qh, ql)
        f1, f2 = lr.found & live, lr.found2 & live
        words = [torch.where(f1 | f2, pos, B), torch.where(f1, lr.idx, 0),
                 torch.where(f2, lr.idx2, 0)]
    deg8 = deg.to(torch.uint8)
    return nxt + (torch.cat(words + [deg8.sum(dim=1, dtype=torch.int32),
                                     deg8.argmax(dim=1).to(torch.int32),
                                     adv.to(torch.int32), n.reshape(1)]),)


def chunk_before_after(eng, px, py, chunk, label, seconds, make_engine):
    """One chunk through the kernels (`chunk`) held to chunk_composition's
    plain versions, then beside the torch route (chunk_composition through
    K1, K2 and the probes): each one's device operations a chunk
    (torch.profiler), enqueue and card ms a chunk, and keys/s over
    `seconds` of the engine make_engine() gives with its chunk function
    replaced by the torch route (the kernels' own window is the phase's).
    Returns the before figures."""
    import torch

    got = chunk()[2]
    t0 = time.time()
    want = chunk_composition(eng, px, py, plain=True)[2]
    plain_s = time.time() - t0
    err = max_abs_err([got], [want])
    if err or got.shape != want.shape:
        fail(f"{label}: the chunk through the kernels differs from its plain versions "
             f"(max_abs_err {err})")
    prev = lambda: chunk_composition(eng, px, py)
    if max_abs_err([prev()[2]], [got]):
        fail(f"{label}: the torch route differs from the chunk through the kernels")
    reps = 10
    fig = {}
    for name, fn in (("before", prev), ("after", chunk)):
        ops, memsets = device_ops(fn)
        fig[name] = dict(ops=ops, memsets=memsets, enqueue_ms=enqueue_ms(fn, reps),
                         card_ms=device_ms(fn, reps)[0])
    eng_prev = make_engine()
    eng_prev._chunk_fn = lambda px, py: chunk_composition(eng_prev, px, py)
    marks, enqueue = marked(eng_prev)
    torch.cuda.synchronize()
    t0 = time.time()
    found = eng_prev.search(max_seconds=seconds, stop_on_first=False)
    torch.cuda.synchronize()
    dt = time.time() - t0
    if any(f.private_key != PUZZLE64_KEY for f in found):
        fail(f"{label}: the torch route found a wrong key: {[hex(f.private_key) for f in found]}")
    busy = sum(a.elapsed_time(b) for a, b in marks)
    span = marks[0][0].elapsed_time(marks[-1][1])
    fig["before"] |= dict(keys_per_s=eng_prev.stats.keys_covered / dt, idle=1 - busy / span,
                          window_enqueue_ms=1000 * sum(enqueue) / len(marks))
    log(f"{label}: a chunk through the kernels equal to its plain versions (max_abs_err 0; "
        f"plain {plain_s:.1f} s) and to the torch route; a chunk before (the torch route: torch "
        f"ops after the level-1 probe) and after (the bloom2 stage and summary kernels): "
        + "; ".join(f"{k} {v['ops'] or 'not measured: the profiler saw no'} device operations "
                    f"({v['memsets']} memsets; torch.profiler), enqueue {v['enqueue_ms']:.4f} "
                    f"ms, card {v['card_ms']:.4f} ms" for k, v in fig.items())
        + f"; before, {seconds:.0f} s of the engine on the torch route: "
        f"{fig['before']['keys_per_s']:.4e} keys/s, idle share {fig['before']['idle']:.4f}, "
        f"enqueue {fig['before']['window_enqueue_ms']:.3f} ms a chunk ({len(marks)} chunks); "
        f"card {card_line()}")
    return fig


def phase3d_device(dev, m, seconds, clock):
    """Device-resolve BSGS at full width (bench.py with BENCH_RESOLVE=device);
    returns (its launch counts from the table build to the end of the
    throughput window, the table, its bitmap)."""
    import numpy as np
    import torch

    from keyhuntm1cpu_tpu_torch.curve import pwalk
    from keyhuntm1cpu_tpu_torch.engine import bsgs
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp
    from keyhuntm1cpu_tpu_torch.ref import ecref

    params = bsgs_params(m, "device")
    pub63 = ecref.scalar_mult(PUZZLE63_KEY)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    table = bsgs.build_baby_table(m, BUILD_BLOCK, dev)
    torch.cuda.synchronize()
    t_table = time.time() - t0
    table_peak = torch.cuda.max_memory_allocated()
    t0 = time.time()
    bm = bmp.build_bitmap_device(table, MAIN_BITS)
    b2 = bsgs._bloom2_for_table(table)
    torch.cuda.synchronize()
    t_filters = time.time() - t0
    _, n_setup = launch_counts()
    steps = max(0, -(-(m - 2 * BUILD_BLOCK) // (bsgs.BUILD_BLOCKS * BUILD_BLOCK)))
    want = zero_counts() | dict(advance_chain=steps, walk_blocks=steps,
                                insert_keys=2 * -(-m // bmp.TABLE_SLICE))
    if n_setup != want:
        fail(f"phase 3d: table and filters launched {n_setup}, expected {want}")
    # the table: sorted, a permutation of j = 1..m, and 64 entries against ecref
    rng = np.random.default_rng(63)
    sample = torch.from_numpy(rng.integers(0, m, 64)).to(dev)
    keys = (table.key[sample].cpu().numpy().view(np.uint64) ^ np.uint64(1 << 63)).tolist()
    js = table.idx[sample].cpu().numpy().view(np.uint32).tolist()
    bad = [j for j, k in zip(js, keys) if ecref.scalar_mult(j)[0] & ((1 << 64) - 1) != k]
    if (bad or not bool((table.key[1:] >= table.key[:-1]).all())
            or int(table.idx.sum(dtype=torch.int64)) != m * (m + 1) // 2):
        fail(f"phase 3d: the table is not sorted, not j = 1..m, or differs from ecref at {bad}")
    log(f"phase 3d: device-resolve table m=2^{m.bit_length() - 1} built on the card in "
        f"{t_table:.2f} s ({steps} walk steps, one stable sort; peak "
        f"{table_peak / 2**30:.2f} GiB); bitmap 2^{bm.bits_log2} and bloom2 "
        f"2^{b2.bits_log2} bits from it in {t_filters:.2f} s; sorted, j = 1..m, 64 entries "
        f"equal to ecref; launches {n_setup}")

    eng = bsgs.BSGSEngine([pub63], *PUZZLE64_RANGE, params, device=dev, table=table, bitmap=bm)
    if eng.bloom2 is not b2:
        fail("phase 3d: the engine did not take the table's cached bloom2")
    window = U * eng.stride
    eng63 = bsgs.BSGSEngine([pub63], PUZZLE63_KEY - 3 * window, PUZZLE63_KEY + 3 * window,
                            params, device=dev, table=table, bitmap=bm)
    t0 = time.time()
    found = [f.private_key for f in eng63.search()]
    if found != [PUZZLE63_KEY]:
        fail(f"phase 3d: puzzle-63 recovery failed: {[hex(k) for k in found]}")
    _, n63 = launch_counts()
    d63 = delta(n63, n_setup)
    if d63["advance_chain"] < 1 or d63 != chunk_launches(eng63, d63["advance_chain"]):
        fail(f"phase 3d: puzzle-63 search launched {d63}")
    log(f"phase 3d: puzzle-63 key 0x{PUZZLE63_KEY:x} recovered bit-exact in "
        f"{time.time() - t0:.2f} s (C1={eng63.C1}, C2={eng63.C2}); launches {d63}")

    eng64 = bsgs.BSGSEngine([ecref.scalar_mult(PUZZLE64_KEY)], *PUZZLE64_RANGE, params,
                            device=dev, table=table, bitmap=bm)
    marks, enqueue = marked(eng64)
    dec = host_timed(eng64, "_consume_summary")
    torch.cuda.synchronize()
    t0 = time.time()
    found = eng64.search(max_seconds=seconds, stop_on_first=False)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    if any(f.private_key != PUZZLE64_KEY for f in found):
        fail(f"phase 3d: throughput search found a wrong key: {[hex(f.private_key) for f in found]}")
    _, n_main = launch_counts()
    d64 = delta(n_main, n63)
    chunks = eng64.stats.keys_covered // (K * U * eng64.stride)
    if chunks != len(marks) or d64 != chunk_launches(eng64, chunks):
        fail(f"phase 3d: throughput search launched {d64} for {len(marks)} chunks dispatched, "
             f"{chunks} counted")
    busy = sum(a.elapsed_time(b) for a, b in marks)
    span = marks[0][0].elapsed_time(marks[-1][1])
    log(f"phase 3d: throughput {chunks} chunks in {elapsed:.2f} s -> "
        f"{eng64.stats.keys_covered / elapsed:.4e} keys/s; puzzle 64's key "
        f"{'found bit-exact' if found else 'not reached'}; device idle share "
        f"{1 - busy / span:.4f} (busy {busy / chunks:.3f} ms per chunk); host enqueue "
        f"{1000 * sum(enqueue) / chunks:.3f} ms, decode {1000 * dec[0] / dec[1]:.3f} ms per "
        f"chunk; launches {d64}")

    # one chunk: through the kernels against the plain versions, beside PR
    # 15's route (device operations, enqueue, card time, keys/s), and its
    # card time split
    reps = 10
    px, py = eng64._initial_base(0)
    chunk = lambda: bsgs.chunk_impl(px, py, eng64.tab_x, eng64.tab_y, eng64.adv_x, eng64.adv_y,
                                    bm, table, b2, U=U, K=K, T=1, C1=eng64.C1, C2=eng64.C2,
                                    adv_tab=eng64.adv_tab, pair_tab=eng64.pair_tab)
    got = chunk()[2]
    if got.shape != (3 * eng64.C2 + 3 * K + 1,):
        fail(f"phase 3d: a chunk summary of {tuple(got.shape)} words")
    fig = chunk_before_after(eng64, px, py, chunk, "phase 3d", PREV_SECONDS, lambda: bsgs.BSGSEngine(
        [ecref.scalar_mult(PUZZLE64_KEY)], *PUZZLE64_RANGE, params, device=dev, table=table,
        bitmap=bm))
    tot_ms = fig["after"]["card_ms"]
    pxt, pyt = px.t().contiguous(), py.t().contiguous()
    pt = eng64.pair_tab
    k1_ms, (bx, by, _, _, _, *cen) = device_ms(lambda: pwalk.advance_chain(
        pxt, pyt, eng64.adv_x, eng64.adv_y, K, eng64.adv_tab, pt and pt[2:]), reps)
    pairs = (*pt[:2], *cen) if pt else None
    k2_ms, (qlo, qhi, _) = device_ms(lambda: pwalk.walk_blocks(bx, by, eng64.tab_x,
                                                              eng64.tab_y, None, pairs), reps)
    n1 = int(bmp.probe_compact(bm, qhi.reshape(-1), qlo.reshape(-1), eng64.C1).n)
    chunk_split(eng64, px, py, "phase 3d")
    log(f"phase 3d: a chunk {tot_ms:.3f} ms on the card = K1 {k1_ms:.3f} + K2 {k2_ms:.3f} + "
        f"cascade, exact search and summary {tot_ms - k1_ms - k2_ms:.3f} ({n1} level-1 "
        f"survivors of {K * U}, C1={eng64.C1}; {int(got[-1])} after bloom2, C2={eng64.C2}); "
        f"keys/s before {fig['before']['keys_per_s']:.4e} (the torch route) and after "
        f"{eng64.stats.keys_covered / elapsed:.4e} (this phase's window)")
    log(f"phase 3d: device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"(table {(table.key.numel() * 12) / 2**30:.2f} GiB, bitmap "
        f"{bm.words.numel() * 4 / 2**30:.2f}, bloom2 {b2.words.numel() * 4 / 2**30:.2f}), "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak; card {card_line()}")
    return n_main, table, bm, eng64.stats.keys_covered / elapsed


def phase3d_large(dev, ms):
    """One device-resolve chunk at each larger m: the table build, the
    filters, device memory and the cascade's survivors against its budgets
    (C1, and C2 after the bloom2, capped at 2^32 bits)."""
    import gc

    import torch

    from keyhuntm1cpu_tpu_torch.curve import pwalk
    from keyhuntm1cpu_tpu_torch.engine import bsgs
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp
    from keyhuntm1cpu_tpu_torch.ref import ecref

    for m in ms:
        bsgs._BLOOM2_CACHE.clear()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        table = bsgs.build_baby_table(m, BUILD_BLOCK, dev)
        torch.cuda.synchronize()
        t_table = time.time() - t0
        t0 = time.time()
        bm = bmp.build_bitmap_device(table, MAIN_BITS)
        eng = bsgs.BSGSEngine([ecref.scalar_mult(PUZZLE64_KEY)], *PUZZLE64_RANGE,
                              bsgs_params(m, "device"), device=dev, table=table, bitmap=bm)
        torch.cuda.synchronize()
        t_filters = time.time() - t0
        px, py = eng._initial_base(0)
        t0 = time.time()
        _, _, out = eng._chunk_fn(px, py)
        n_out = int(out[-1])
        chunk_s = time.time() - t0
        # the chunk's level-1 and level-2 survivors, apart
        res = pwalk.chunk_multi(px, py, eng.tab_x, eng.tab_y, eng.adv_x, eng.adv_y, K=K, U=U,
                                T=1, adv_tab=eng.adv_tab, pair_tab=eng.pair_tab)
        pc = bmp.probe_compact(bm, res.qhi.reshape(-1), res.qlo.reshape(-1), eng.C1)
        n2 = int(bmp.probe_bloom2(eng.bloom2, pc.qhi, pc.qlo)[: min(int(pc.n), eng.C1)].sum())
        log(f"phase 3d: m=2^{m.bit_length() - 1}: table built in {t_table:.2f} s, bitmap "
            f"2^{bm.bits_log2} and bloom2 2^{eng.bloom2.bits_log2} bits "
            f"(load {2 * m / 2**eng.bloom2.bits_log2:.3f}) in {t_filters:.2f} s; one chunk "
            f"({chunk_s * 1000:.1f} ms with its copy): {int(pc.n)} level-1 survivors "
            f"(C1={eng.C1}), {n2} after bloom2 (C2={eng.C2}), n_candidates {n_out} -> "
            f"{'overflow: the host rescans the chunk' if n_out > eng.C2 else 'no overflow'}; "
            f"device memory peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del table, bm, eng, out, res, pc
    bsgs._BLOOM2_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()


def phase3b_server(dev, m, table):
    """bsgsd on phase 3d's resident table: a BSGSService and a BSGSDServer
    on localhost answer a planted key, a miss, a 408 at a zero deadline and,
    at slice_chunks = 1, a small request queued behind a large one, which
    comes back first; every answer right."""
    import socket
    import threading

    from keyhuntm1cpu_tpu_torch.ref import ecref
    from keyhuntm1cpu_tpu_torch.server import BSGSDServer, BSGSService

    t0 = time.time()
    service = BSGSService(bsgs_params(m, "device"), table=table, device=dev)
    t_boot = time.time() - t0
    srv = BSGSDServer(("127.0.0.1", 0), service)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def ask(line):
        t = time.perf_counter()
        with socket.create_connection(srv.server_address, timeout=300) as s:
            s.sendall(line.encode() + b"\n")
            s.shutdown(socket.SHUT_WR)
            resp = b"".join(iter(lambda: s.recv(4096), b"")).decode()
        return resp, time.perf_counter() - t

    pub = lambda k: ecref.serialize_pubkey(ecref.scalar_mult(k)).hex()
    try:
        window = U * 2 * m
        rng63 = f"{PUZZLE63_KEY - 3 * window:x}:{PUZZLE63_KEY + 3 * window:x}"
        hit, hit_s = ask(f"{pub(PUZZLE63_KEY)} {rng63}")
        miss, miss_s = ask(f"{pub(PUZZLE64_KEY)} {rng63}")
        service.max_seconds = 0.0
        late, _ = ask(f"{pub(PUZZLE63_KEY)} {rng63}")
        service.max_seconds, service.slice_chunks = None, 1
        span = K * U * 2 * m  # keys a chunk
        a = 1 << 63
        big_key, small_key = a + 63 * span + 12345, a + 5 * span + 777
        done = {}

        def run(name, line):
            done[name] = ask(line) + (time.perf_counter(),)

        t_big = threading.Thread(target=run, args=("big", f"{pub(big_key)} {a:x}:{a + 64 * span:x}"))
        t_big.start()
        time.sleep(0.2)  # the large request takes the lock first
        run("small", f"{pub(small_key)} {a + 5 * span:x}:{a + 6 * span:x}")
        t_big.join()
    finally:
        srv.shutdown()
        srv.server_close()
    (small, small_s, small_t), (big, big_s, big_t) = done["small"], done["big"]
    if (hit != f"{PUZZLE63_KEY:064x}" or miss != "404 Not Found" or late != "408 Request Timeout"
            or small != f"{small_key:064x}" or big != f"{big_key:064x}" or not small_t < big_t):
        fail(f"phase 3b: answers {hit!r} {miss!r} {late!r}, interleaved {small!r} "
             f"{big!r} (small done first: {small_t < big_t})")
    log(f"phase 3b: bsgsd on the resident table (service up in {t_boot:.2f} s, one warm "
        f"chunk): puzzle 63's key answered in {1000 * hit_s:.1f} ms, a miss over the same "
        f"6 steps 404 in {1000 * miss_s:.1f} ms, max_seconds=0 408; slice_chunks=1: a 1-chunk "
        f"request behind a 64-chunk one answered in {1000 * small_s:.1f} ms, before it "
        f"({1000 * big_s:.1f} ms); all answers right")


def phase4r_resume(dev):
    """Kill and resume at full width: the fused rmd160 chunk (T = 32, keys
    in chunks 0 and 3) and minikeys at B = 2^23."""
    import hashlib
    import tempfile

    from keyhuntm1cpu_tpu_torch.core.checkpoint import CheckpointManager
    from keyhuntm1cpu_tpu_torch.engine import minikeys as mk
    from keyhuntm1cpu_tpu_torch.engine.brute import BruteEngine, BruteParams
    from keyhuntm1cpu_tpu_torch.ref import ecref, hashref
    from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet

    a = BRUTE_RANGE[0]
    early, late = a + 5, a + 3 * K * U + 77
    keys = list(range(1, 31)) + [early, late]
    ts = TargetSet(kind="hash160", labels=[str(k) for k in keys],
                   raw=[brute_artifact("rmd160", ecref.scalar_mult(k)) for k in keys])
    params = BruteParams(block_u=U, steps_per_chunk=K)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(os.path.join(tmp, "ck.json"), every_s=0)
        eng = BruteEngine(ts, *BRUTE_RANGE, mode="rmd160", params=params, device=dev)
        f1 = [f.private_key for f in eng.search(max_steps=2 * K, checkpoint=mgr)]
        ck1 = mgr.load()
        eng = BruteEngine(ts, *BRUTE_RANGE, mode="rmd160", params=params, device=dev)
        f2 = sorted(f.private_key for f in eng.search(max_steps=4 * K, checkpoint=mgr))
        ck2 = mgr.load()
    if (f1 != [early] or ck1.chunks_done != 2 * K or f2 != [early, late]
            or ck2.chunks_done != 4 * K or ck2.keys_covered != 4 * K * U
            or eng.stats.keys_covered != 4 * K * U):
        fail(f"fused resume: {f1} then {f2}, checkpoints {ck1.chunks_done}, {ck2.chunks_done}")
    log(f"phase 4r: fused rmd160 T=32 (U={U}, K={K}): 2 chunks found the chunk-0 key, a fresh "
        f"engine resumed from the checkpoint, reported it again from the file and found the "
        f"chunk-3 key; {ck2.chunks_done} steps, {ck2.keys_covered} keys ({time.time() - t0:.1f} s)")

    for c in range(1 << 18):  # phase 4b's gate key, in chunk 0
        s_ = MK_PREFIX + mk._b58_digits(c // mk.LOW_SPAN, 5) + mk._b58_digits(c % mk.LOW_SPAN, 5)
        if hashlib.sha256((s_ + "?").encode()).digest()[0] == 0:
            break
    key = int.from_bytes(hashlib.sha256(s_.encode()).digest(), "big")
    target = TargetSet(kind="hash160", labels=["planted"], raw=[
        hashref.pubkey_to_hash160(ecref.scalar_mult(key), compressed=False)])
    params = mk.tuned_params(batch=MK_BATCH)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(os.path.join(tmp, "ck.json"), every_s=0)
        eng = mk.MinikeyEngine(target, prefix=MK_PREFIX, params=params, device=dev)
        f1 = [f.private_key for f in eng.search(max_chunks=1, checkpoint=mgr)]
        ck1 = mgr.load()
        eng = mk.MinikeyEngine(target, params=params, device=dev)  # a random prefix
        f2 = [f.private_key for f in eng.search(max_chunks=2, stop_on_first=False,
                                                 checkpoint=mgr)]
        ck2 = mgr.load()
    if (f1 != [key] or ck1.extra != {"prefix": MK_PREFIX, "counter": MK_BATCH} or f2 != [key]
            or eng.prefix != MK_PREFIX or eng.counter != 3 * MK_BATCH
            or ck2.extra != {"prefix": MK_PREFIX, "counter": 3 * MK_BATCH}
            or ck2.keys_covered != 3 * MK_BATCH):
        fail(f"minikeys resume: {f1} {ck1.extra} then {f2} {ck2.extra}, engine at "
             f"{eng.prefix} {eng.counter}")
    log(f"phase 4r: minikeys B={MK_BATCH}: one chunk found the planted key, a fresh engine "
        f"adopted prefix {MK_PREFIX} and counter {MK_BATCH} from the checkpoint, reported the "
        f"key again and ran 2 more chunks to counter {eng.counter} ({time.time() - t0:.1f} s)")


def walker_resume(ts, a, b, params, dev, planted):
    """Kill and resume on the walker path at phase 4c's shape: one chunk,
    then a fresh engine resumes for a second."""
    import tempfile

    from keyhuntm1cpu_tpu_torch.core.checkpoint import CheckpointManager
    from keyhuntm1cpu_tpu_torch.engine.brute import BruteEngine

    K_, W = params.steps_per_chunk, params.walkers
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(os.path.join(tmp, "ck.json"), every_s=0)
        eng = BruteEngine(ts, a, b, mode="rmd160", params=params, device=dev)
        f1 = sorted(f.private_key for f in eng.search(max_steps=K_, checkpoint=mgr))
        eng = BruteEngine(ts, a, b, mode="rmd160", params=params, device=dev)
        f2 = sorted(f.private_key for f in eng.search(max_steps=2 * K_, checkpoint=mgr))
        ck = mgr.load()
    per = K_ * W * (2 * params.block_u + 1)  # keys a chunk
    if (f1 != planted or f2 != planted or ck.chunks_done != 2 * K_
            or ck.keys_covered != 2 * per or eng.stats.keys_covered != 2 * per):
        fail(f"walker resume: {len(f1)} then {len(f2)} keys, checkpoint {ck.chunks_done} steps")
    log(f"phase 4r: walker rmd160 at phase 4c's shape: one chunk found the {len(planted)} "
        f"planted keys, a fresh engine resumed for the second chunk and reported them again "
        f"from the checkpoint; {ck.chunks_done} steps, {ck.keys_covered} keys "
        f"({time.time() - t0:.1f} s)")


def subprocess_env(here):
    """The environment of a port subprocess: this checkout on its path."""
    return dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))


def pub_file(path, key):
    from keyhuntm1cpu_tpu_torch.ref import ecref

    with open(path, "w") as f:
        f.write(ecref.serialize_pubkey(ecref.scalar_mult(key)).hex() + "\n")
    return path


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def stop_process(proc):
    """Terminate a subprocess that is still running (no process outlives the smoke)."""
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=60)


class FleetLog:
    """A coordinator's leases and reports with their host times (phase 3f)."""

    def __init__(self):
        self.events = []  # (time, op, worker, unit_id, status)

    def coordinator(self, *a, **kw):
        from keyhuntm1cpu_tpu_torch.dist.coordinator import WorkCoordinator

        events = self.events

        class Logged(WorkCoordinator):
            def request_work(self, worker_id):
                r = super().request_work(worker_id)
                if r["unit"] is not None:
                    events.append((time.time(), "lease", worker_id, r["unit"]["unit_id"], None))
                return r

            def report(self, worker_id, unit_id, status, found=None):
                events.append((time.time(), "report", worker_id, unit_id, status))
                return super().report(worker_id, unit_id, status, found)

        return Logged(*a, **kw)


def phase3f_fleet(dev, m, rate3d, here):
    """The coordinator and the port's worker CLI on the card: puzzle 63's
    whole range [2^62, 2^63) in FLEET_UNITS units aligned to one chunk, a
    ghost lease backdated and reclaimed, the first worker stopped by
    SIGTERM partway through a unit (reported failed, requeued), a second
    worker finishing the range. Returns the workers' launch counts."""
    import signal
    import tempfile

    from keyhuntm1cpu_tpu_torch.dist.coordinator import CoordinatorServer

    chunk = K * U * 2 * m
    a, b = FLEET_RANGE
    key_unit = (PUZZLE63_KEY - a) * FLEET_UNITS // (b - a)
    fl = FleetLog()
    coord = fl.coordinator(a, b, FLEET_UNITS, align=chunk, lease_s=600.0, stop_on_first=False)
    if coord.n_units != FLEET_UNITS or (b - a) // FLEET_UNITS % chunk:
        fail(f"phase 3f: {coord.n_units} units of the range, not {FLEET_UNITS} chunk-aligned")
    ghost = coord.request_work("ghost")
    with coord._lock:  # the ghost's lease expires: its unit is reclaimed
        uid = int(ghost["unit"]["unit_id"])
        unit, lease = coord._assigned[uid]
        coord._assigned[uid] = (unit, type(lease)("ghost", 0.0))
    srv = CoordinatorServer(("127.0.0.1", 0), coord)
    srv.start_background()
    procs, outs = [], []
    with tempfile.TemporaryDirectory() as tmp:
        pub = pub_file(os.path.join(tmp, "p63.pub"), PUZZLE63_KEY)
        cmd = [sys.executable, "-m", "keyhuntm1cpu_tpu_torch.dist.worker",
               "-c", f"127.0.0.1:{srv.server_address[1]}", "-f", pub, "--m-babies", str(m),
               "-u", str(U), "--chunk-steps", str(K)]

        def start(i):
            out = open(os.path.join(tmp, f"w{i}.log"), "w+")
            outs.append(out)
            procs.append(subprocess.Popen(cmd, cwd=tmp, env=subprocess_env(here), stdout=out,
                                          stderr=subprocess.STDOUT))

        try:
            t0 = time.time()
            start(0)
            w0, stop_unit = None, None
            while stop_unit is None:
                if procs[0].poll() is not None or time.time() - t0 > 600:
                    fail(f"phase 3f: the first worker ended (rc {procs[0].poll()}) before "
                         f"{FLEET_STOP_AFTER} units")
                ev = list(fl.events)
                w0 = next((e[2] for e in ev if e[2] != "ghost"), None)
                done = sum(e[1] == "report" and e[2] == w0 for e in ev)
                leases = [e for e in ev if e[1] == "lease" and e[2] == w0]
                if done >= FLEET_STOP_AFTER and len(leases) > done and leases[-1][3] != key_unit:
                    stop_unit = leases[-1][3]
                    time.sleep(0.05)  # into the unit's chunks
                    procs[0].send_signal(signal.SIGTERM)
                time.sleep(0.005)
            start(1)  # boots while the first one stops
            for p in procs:
                p.wait(timeout=600)
        finally:
            for p in procs:
                stop_process(p)
            srv.shutdown()
            srv.server_close()
        texts = []
        for out in outs:
            out.seek(0)
            texts.append(out.read())
            out.close()
    rcs = [p.returncode for p in procs]
    units, launches, builds = [], zero_counts(), []
    for i, text in enumerate(texts):
        for ln in text.splitlines():
            if ln.startswith("[unit] "):
                units.append(dict(json.loads(ln[7:]), worker=i))
            elif ln.startswith("[launches] "):
                launches = {k: launches[k] + v for k, v in json.loads(ln[11:]).items()}
            elif "resident device-resolve structures" in ln:
                builds.append(float(ln.split(" built in ")[1].split()[0]))
    ev = fl.events
    st = coord.status()
    found = [f["private_key"] for f in coord.found_keys()]
    real = [e for e in ev if e[2] != "ghost"]
    fails = [e for e in real if e[1] == "report" and e[4] == "failed"]
    completions = sorted(e[3] for e in real if e[1] == "report" and e[4] in ("done", "found"))
    leased = {u: sum(e[1] == "lease" and e[3] == u for e in real) for u in range(FLEET_UNITS)}
    want_leases = {u: 1 + (u == stop_unit) for u in range(FLEET_UNITS)}
    if (rcs != [0, 0] or st["completed"] != FLEET_UNITS or found != [f"{PUZZLE63_KEY:x}"]
            or [(e[2], e[3]) for e in fails] != [(w0, stop_unit)]
            or completions != list(range(FLEET_UNITS)) or leased != want_leases
            or len(builds) != 2):
        fail(f"phase 3f: worker rcs {rcs}, {st['completed']} units completed, found {found}, "
             f"failed reports {fails} (stop sent in unit {stop_unit}), completions "
             f"{completions}, leases {leased}, builds {builds}; logs:\n"
             + "\n".join(t[-3000:] for t in texts))
    first = min(e[0] for e in real if e[1] == "lease")
    last = max(e[0] for e in real if e[1] == "report")
    full = [u for u in units if u["status"] in ("done", "found") and not u["first"]]
    ms = lambda u, *keys: 1000 * sum(u[k] for k in keys)  # noqa: E731
    mean = lambda *keys: sum(ms(u, *keys) for u in full) / len(full)  # noqa: E731
    over, body = mean("rpc_s", "engine_s", "base_s"), mean("search_s") - mean("base_s")
    per_unit = (b - a) // FLEET_UNITS
    log(f"phase 3f: fleet over puzzle 63's range [2^62, 2^63): {FLEET_UNITS} units of "
        f"{per_unit // chunk} chunks, 2 worker processes (-u {U} --chunk-steps {K} "
        f"--m-babies {m}); the ghost's unit {uid} reclaimed, SIGTERM in unit {stop_unit} "
        f"(reported failed, requeued, finished by the second worker), key 0x{PUZZLE63_KEY:x} "
        f"found once in unit {key_unit}; every other unit covered once")
    log(f"phase 3f: fleet {(b - a) / (last - first):.4e} keys/s over {last - first:.2f} s from "
        f"the first lease to the last report (phase 3d's search in this run: {rate3d:.4e}); "
        f"{1000 * per_unit / body:.4e} keys/s over the units' chunks alone")
    log(f"phase 3f: per unit ({len(full)} full units after each worker's first): overhead "
        f"{over:.1f} ms (RPCs {mean('rpc_s'):.1f}, engine {mean('engine_s'):.1f}, "
        f"_initial_base {mean('base_s'):.1f}) beside chunks {body:.1f} ms "
        f"({100 * over / (over + body):.1f} % overhead); units (worker, id, overhead ms, "
        f"chunks ms): " + ", ".join(
            f"({u['worker']}, {u['unit_id']}, {ms(u, 'rpc_s', 'engine_s', 'base_s'):.1f}, "
            f"{ms(u, 'search_s') - ms(u, 'base_s'):.1f})" for u in units))
    log(f"phase 3f: each worker's resident table, bitmap and bloom2 built in "
        f"{', '.join(f'{t:.2f}' for t in builds)} s (with its first engine); worker launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def phase4f_fleet(dev):
    """Fleet brute and fleet minikeys in this process: brute_search_fn in
    rmd160 at phase 4's shape over 4 units of 2 chunks (keys planted in
    units 1 and 3), minikeys_search_fn at B = 2^23 over 4 counter units of
    one chunk (the first valid minikey of unit 2 planted). Returns the
    launch counts of both runs, counted from zero."""
    import hashlib
    import threading

    import torch

    from keyhuntm1cpu_tpu_torch.dist import CoordinatorServer, DistributedWorker, WorkCoordinator
    from keyhuntm1cpu_tpu_torch.dist.worker import brute_search_fn, minikeys_search_fn
    from keyhuntm1cpu_tpu_torch.engine import minikeys as mk
    from keyhuntm1cpu_tpu_torch.engine.brute import BruteParams
    from keyhuntm1cpu_tpu_torch.ref import ecref, hashref
    from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet

    def run(fn, a, b, n_units, align):
        coord = WorkCoordinator(a, b, n_units, align=align, lease_s=600.0, stop_on_first=False)
        srv = CoordinatorServer(("127.0.0.1", 0), coord)
        srv.start_background()
        try:
            w = DistributedWorker("127.0.0.1", srv.server_address[1], fn, poll_s=0.1)
            t = threading.Thread(target=w.run)
            t0 = time.time()
            t.start()
            t.join(timeout=600)
            if t.is_alive():
                fail("phase 4f: the worker did not finish in 600 s")
            torch.cuda.synchronize()
            return coord, w, time.time() - t0
        finally:
            srv.shutdown()
            srv.server_close()

    counts = {}
    a = BRUTE_RANGE[0]
    unit = 2 * K * U
    planted = [a + unit + unit // 3, a + 4 * unit - 7]
    keys = list(range(1, 31)) + planted
    ts = TargetSet(kind="hash160", labels=[str(k) for k in keys],
                   raw=[brute_artifact("rmd160", ecref.scalar_mult(k)) for k in keys])
    fn = brute_search_fn(ts, mode="rmd160", params=BruteParams(block_u=U, steps_per_chunk=K),
                         device=dev)
    reset_counts()
    coord, w, dt = run(fn, a, a + 4 * unit, 4, unit)
    _, n = launch_counts()
    found = sorted(int(f["private_key"], 16) for f in coord.found_keys())
    units = {f["unit_id"] for f in coord.found_keys()}
    want = zero_counts() | dict(advance_chain=8, brute_walk_blocks=8, compact_hits=8)
    if (found != planted or units != {1, 3} or coord.status()["completed"] != 4 or n != want
            or [t["keys"] for t in fn.timings] != [unit] * 4):
        fail(f"phase 4f: brute found {[hex(k) for k in found]} in units {units}, planted "
             f"{[hex(k) for k in planted]}; launches {n}, expected {want}")
    counts["brute"] = n
    log(f"phase 4f: fleet brute rmd160 T=32 (U={U}, K={K}): 4 units of 2 chunks in {dt:.2f} s, "
        f"the keys planted in units 1 and 3 found once each; per unit: engine "
        f"{1000 * sum(t['engine_s'] for t in fn.timings) / 4:.1f} ms, search "
        f"{1000 * sum(t['search_s'] for t in fn.timings) / 4:.1f} ms; launches {n}")

    B = MK_BATCH
    for c in range(2 * B, 3 * B):  # the first valid minikey of unit 2
        s_ = MK_PREFIX + mk._b58_digits(c // mk.LOW_SPAN, 5) + mk._b58_digits(c % mk.LOW_SPAN, 5)
        if hashlib.sha256((s_ + "?").encode()).digest()[0] == 0:
            break
    else:
        fail("phase 4f: no valid minikey in unit 2")
    key = int.from_bytes(hashlib.sha256(s_.encode()).digest(), "big")
    target = TargetSet(kind="hash160", labels=["planted"], raw=[
        hashref.pubkey_to_hash160(ecref.scalar_mult(key), compressed=False)])
    fn = minikeys_search_fn(target, MK_PREFIX, params=mk.tuned_params(batch=B), device=dev)
    reset_counts()
    coord, w, dt = run(fn, 0, 4 * B, 4, B)
    _, n = launch_counts()
    got = [(f["private_key"], f["unit_id"]) for f in coord.found_keys()]
    want = zero_counts() | dict(minikey_valid=4, minikey_compact_keys=4, scalar_mult=4,
                                hash160_x2=4, hash160_u=4)
    if got != [(f"{key:x}", 2)] or coord.status()["completed"] != 4 or n != want:
        fail(f"phase 4f: minikeys found {got}, planted {s_} (counter {c}) in unit 2; launches "
             f"{n}, expected {want}")
    counts["minikeys"] = n
    log(f"phase 4f: fleet minikeys B={B}: 4 counter units of one chunk in {dt:.2f} s, the first "
        f"valid minikey of unit 2 ({s_}, counter {c}) found once; per unit: engine "
        f"{1000 * sum(t['engine_s'] for t in fn.timings) / 4:.1f} ms, search "
        f"{1000 * sum(t['search_s'] for t in fn.timings) / 4:.1f} ms; launches {n}")
    return counts


def cli_run(here, cwd, args, timeout=600):
    """The port's CLI in a subprocess: (rc, stdout + stderr)."""
    res = subprocess.run([sys.executable, "-m", "keyhuntm1cpu_tpu_torch.cli", *args], cwd=cwd,
                         env=subprocess_env(here), capture_output=True, text=True,
                         timeout=timeout)
    return res.returncode, res.stdout + res.stderr


def phase5c_cli(dev, m, here):
    """The CLI on the card, as subprocesses: -m bsgs from a --config file
    with --metrics-port (polled during the run) and --notify-cmd; -m rmd160
    -S writing the reference .dat and a second run reading it; -z 4."""
    import tempfile
    import threading
    import urllib.request

    from keyhuntm1cpu_tpu_torch.filter.bitmap import default_bits_log2, scaled_bits_log2
    from keyhuntm1cpu_tpu_torch.ref import ecref

    with tempfile.TemporaryDirectory() as tmp:
        pub = pub_file(os.path.join(tmp, "p63.pub"), PUZZLE63_KEY)
        w = U * 2 * m
        rng63 = f"{PUZZLE63_KEY - 3 * w:x}:{PUZZLE63_KEY + 3 * w:x}"
        with open(os.path.join(tmp, "cfg.json"), "w") as f:
            json.dump({"m_babies": m, "block_u": U, "steps_per_chunk": K}, f)
        with open(os.path.join(tmp, "notify.py"), "w") as f:
            f.write("import sys\nopen(sys.argv[1], 'a').write(' '.join(sys.argv[2:]) + '\\n')\n")
        port = free_port()
        polls, extra = [], {}
        done = threading.Event()

        def poll():
            base = f"http://127.0.0.1:{port}"
            while not done.is_set():
                try:
                    with urllib.request.urlopen(base + "/metrics.json", timeout=5) as r:
                        snap = json.loads(r.read())
                    polls.append(snap["counters"].get("keys_covered", 0.0))
                    if "prom" not in extra:
                        with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
                            extra["prom"] = r.read().decode()
                        with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
                            extra["healthz"] = r.read().decode()
                        extra["info"] = snap["info"]
                except OSError:
                    pass
                time.sleep(0.01)

        poller = threading.Thread(target=poll, daemon=True)
        poller.start()
        t0 = time.time()
        rc, out = cli_run(here, tmp, [
            "--config", "cfg.json", "-m", "bsgs", "-f", pub, "-r", rng63, "--metrics-port",
            str(port), "--notify-cmd", f"{sys.executable} notify.py notified.txt"])
        t_bsgs = time.time() - t0
        done.set()
        poller.join(timeout=30)
        keys = int(out.split("keys/s (")[1].split(" keys)")[0]) if "keys/s (" in out else -1
        prom = {}
        for ln in extra.get("prom", "").splitlines():
            if ln and not ln.startswith("#"):
                name, val = ln.rsplit(" ", 1)
                prom[name] = float(val)
        notified = (open(os.path.join(tmp, "notified.txt")).read()
                    if os.path.exists(os.path.join(tmp, "notified.txt")) else "")
        if (rc != 0 or f"FOUND {PUZZLE63_KEY:064x}" not in out or keys <= 0
                or not polls or polls[0] != 0 or polls[-1] != keys
                or any(y < x for x, y in zip(polls, polls[1:]))
                or "keyhunt_uptime_seconds" not in prom
                or prom.get("keyhunt_keys_covered", 0.0) not in set(polls)
                or extra.get("healthz") != "ok" or extra.get("info") != {"mode": "bsgs"}
                or not notified.startswith(f"{PUZZLE63_KEY:064x} ")
                or f"bsgs: m={m}, device resolve" not in out):
            fail(f"phase 5c: bsgs --config --metrics-port --notify-cmd: rc {rc}, engine keys "
                 f"{keys}, polls {sorted(set(polls))}, /metrics {prom}, /healthz "
                 f"{extra.get('healthz')!r}, info {extra.get('info')}, notified {notified!r}; "
                 f"output:\n{out[-3000:]}")
        log(f"phase 5c: CLI -m bsgs --config (m=2^{m.bit_length() - 1}, U={U}, K={K}) "
            f"--metrics-port --notify-cmd over puzzle 63's +-3-step window: rc 0 in "
            f"{t_bsgs:.1f} s; /metrics.json polled {len(polls)} times, keys_covered "
            f"{' -> '.join(str(int(v)) for v in sorted(set(polls)))} (the engine's {keys}); "
            f"/metrics parsed ({len(prom)} samples), /healthz ok; the notify script got the key")

        # -S in rmd160 mode: the reference .dat, then a run that reads it
        a = BRUTE_RANGE[0]
        tkeys = list(range(1, 32)) + [a + 5]
        with open(os.path.join(tmp, "t32.txt"), "w") as f:
            f.write("".join(brute_artifact("rmd160", ecref.scalar_mult(k)).hex() + "\n"
                            for k in tkeys))
        args = ["-m", "rmd160", "-f", "t32.txt", "-S", "-r", f"{a:x}:{BRUTE_RANGE[1]:x}",
                "-u", str(U), "--chunk-steps", str(K), "--max-chunks", "2"]
        runs = []
        for _ in range(2):
            t0 = time.time()
            rc, out = cli_run(here, tmp, args)
            runs.append((rc, out, time.time() - t0))
        dats = [n for n in os.listdir(tmp) if n.startswith("data_") and n.endswith(".dat")]
        (rc1, out1, t1), (rc2, out2, t2) = runs
        want = f"FOUND {a + 5:064x}"
        if (rc1 != 0 or rc2 != 0 or len(dats) != 1 or f"wrote ./{dats[0]}" not in out1
                or "read 32 targets from the reference cache" not in out2 or "wrote" in out2
                or want not in out1 or want not in out2):
            fail(f"phase 5c: rmd160 -S: rcs {rc1} {rc2}, .dat files {dats}; outputs:\n"
                 f"{out1[-2000:]}\n{out2[-2000:]}")
        log(f"phase 5c: CLI -m rmd160 -S (T=32, U={U}, K={K}): wrote {dats[0]} "
            f"({os.path.getsize(os.path.join(tmp, dats[0]))} bytes) in {t1:.1f} s; a second run "
            f"read its 32 targets back and found the same key 0x{a + 5:x} in {t2:.1f} s")

        mz = Z_M
        wz = U * 2 * mz
        bits = scaled_bits_log2(mz, 4)
        t0 = time.time()
        rc, out = cli_run(here, tmp, [
            "-m", "bsgs", "-f", pub, "-r", f"{PUZZLE63_KEY - 3 * wz:x}:{PUZZLE63_KEY + 3 * wz:x}",
            "--m-babies", str(mz), "-u", str(U), "--chunk-steps", str(K), "-z", "4"])
        if rc != 0 or f"bitmap 2^{bits} bits" not in out or f"FOUND {PUZZLE63_KEY:064x}" not in out:
            fail(f"phase 5c: -z 4 at m={mz}: rc {rc}; output:\n{out[-3000:]}")
        log(f"phase 5c: CLI -m bsgs -z 4 at m=2^{mz.bit_length() - 1}: bitmap 2^{bits} bits "
            f"(scaled_bits_log2(m, 4); default 2^{default_bits_log2(mz)}), key found, "
            f"rc 0 in {time.time() - t0:.1f} s")


def phase5l_legacy(dev, m):
    """The legacy export at the reference's default size: x32 from K6 on the
    card, the three .blm levels and the .tbl timed apart, checked against
    ecref and the host walk; then the native bulk parse of a 2^18-line
    address file beside the python parse. Returns the launch counts of the
    export's x32, counted from zero."""
    import tempfile

    import numpy as np

    from keyhuntm1cpu_tpu_torch import native
    from keyhuntm1cpu_tpu_torch.engine.bsgs import resolve_m
    from keyhuntm1cpu_tpu_torch.ref import ecref, hashref
    from keyhuntm1cpu_tpu_torch.utils import legacy
    from keyhuntm1cpu_tpu_torch.utils.targets import _parse_line_address

    if resolve_m(None, 0x100000000000, 1) != X32_M:
        fail("phase 5l: resolve_m of the reference default is not X32_M")
    reset_counts()
    t0 = time.time()
    x32 = legacy.baby_x_bytes(m, dev)
    t_x32 = time.time() - t0
    _, n = launch_counts()
    batches = -(-m // legacy.X32_BATCH)
    if n != zero_counts() | dict(scalar_mult=batches):
        fail(f"phase 5l: the x32 launched {n}, expected {batches} K6 calls")
    rng = np.random.default_rng(22)
    rows = rng.integers(0, m, 256)
    bad = [int(j) + 1 for j in rows
           if x32[j].tobytes() != ecref.scalar_mult(int(j) + 1)[0].to_bytes(32, "big")]
    walk = legacy.baby_x_bytes(1 << 12, "cpu")
    if bad or not np.array_equal(x32[: 1 << 12], walk):
        fail(f"phase 5l: x32 differs from ecref at j = {bad[:8]} or from the host walk")
    # export_reference_files from this x32, each file's time read off the
    # completion of its write (the levels and the table are built in order)
    marks = [("start", time.time())]

    def marking(fn):
        def wrapped(path, *a):
            fn(path, *a)
            marks.append((os.path.basename(path), time.time()))
        return wrapped

    saved = legacy.write_blm, legacy.write_tbl
    legacy.write_blm, legacy.write_tbl = (marking(f) for f in saved)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            marks[0] = ("start", time.time())
            paths = legacy.export_reference_files(tmp, m, x32=x32)
            sizes = {os.path.basename(p_): os.path.getsize(p_) for p_ in paths}
            t0 = time.time()
            ok = legacy.verify_against_ecref(tmp, m, probes=64)
            t_verify = time.time() - t0
    finally:
        legacy.write_blm, legacy.write_tbl = saved
    times = {nm: t - t_prev for (_, t_prev), (nm, t) in zip(marks, marks[1:])}
    same = list(times) == list(sizes)
    if not ok or not same:
        fail(f"phase 5l: verify_against_ecref {ok}, files written {list(times)} {list(sizes)}")
    log(f"phase 5l: legacy export at m=2^{m.bit_length() - 1} (keyhunt's default -n "
        f"0x100000000000, -k 1: 2^22): x32 by "
        f"K6 on the card in {t_x32:.3f} s ({batches} batches of {legacy.X32_BATCH}, one copy); "
        f"256 random rows equal to ecref, the first 2^12 to the host walk; "
        + ", ".join(f"{nm} {times[nm]:.2f} s ({sizes[nm]} bytes)" for nm in times)
        + f"; verify_against_ecref(probes=64) true in {t_verify:.2f} s; launches {n}")

    # the native bulk parse of an address file beside the python parse
    seeds = rng.integers(0, 256, (PARSE_LINES, 20), dtype=np.uint8)
    t0 = time.time()
    lines = [hashref.b58check_encode(b"\x00" + row.tobytes()) for row in seeds]
    t_gen = time.time() - t0
    text = ("\n".join(lines) + "\n").encode()
    t0 = time.time()
    got = native.parse_addresses(text, PARSE_LINES)
    t_native = time.time() - t0
    t0 = time.time()
    py = [_parse_line_address(ln) for ln in lines[:PARSE_PY_LINES]]
    t_py = time.time() - t0
    if (got.shape != (PARSE_LINES, 20) or not np.array_equal(got, seeds)
            or b"".join(py) != got[:PARSE_PY_LINES].tobytes()):
        fail("phase 5l: the native address parse differs from the python parse")
    log(f"phase 5l: native bulk parse of {PARSE_LINES} base58 addresses in {t_native:.3f} s "
        f"({PARSE_LINES / t_native:.4e} lines/s) beside the python parse of the first "
        f"{PARSE_PY_LINES} in {t_py:.3f} s ({PARSE_PY_LINES / t_py:.4e} lines/s); equal "
        f"hash160s (file made in {t_gen:.1f} s)")
    return n


def shard_devices():
    """Phases 6a-6c's devices: every visible card, repeated up to SHARDS."""
    import torch

    from keyhuntm1cpu_tpu_torch.parallel import default_devices

    return default_devices("cuda", max(SHARDS, torch.cuda.device_count()))


def shard_window(eng, seconds, name):
    """`seconds` of a sharded engine's search_sharded from zeroed launch
    counts: (counts, sharded chunks, wall s, idle share, enqueue ms a
    sharded chunk, decode ms a decoded chunk, card ms a sharded chunk by
    device_ms, before the window)."""
    import torch

    b0 = eng._bases_at(0)
    card_ms, _ = device_ms(lambda: eng._sharded_chunk(b0), 3)
    marks, enqueue = marked(eng, "_sharded_chunk")
    dec = host_timed(eng, "_decode_sharded")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    eng.search_sharded(max_seconds=seconds, stop_on_first=False)
    torch.cuda.synchronize()
    dt = time.time() - t0
    _, n = launch_counts()
    if not marks:
        fail(f"{name}: no sharded chunk in the window")
    busy = sum(a.elapsed_time(b) for a, b in marks)
    span = marks[0][0].elapsed_time(marks[-1][1])
    return (n, len(marks), dt, 1 - busy / span, 1000 * sum(enqueue) / len(marks),
            1000 * dec[0] / max(1, dec[1]), card_ms)


def phase6a_range(m, table, bm, rate3d, seconds, devs):
    """Range-sharded BSGS (parallel/mesh.py ShardedBSGSEngine) at phase
    3d's width on its resident table, bitmap and bloom2; returns the
    throughput window's launch counts."""
    import numpy as np
    import torch

    from keyhuntm1cpu_tpu_torch.engine import bsgs
    from keyhuntm1cpu_tpu_torch.parallel import ShardedBSGSEngine
    from keyhuntm1cpu_tpu_torch.ref import ecref

    params = bsgs_params(m, "device")
    D, w = len(devs), U * 2 * m
    # two chunks a shard; puzzle 63's key in the last shard's first chunk
    a = PUZZLE63_KEY - ((D - 1) * 2 * K + K // 2) * w - 12345
    pub63 = [ecref.scalar_mult(PUZZLE63_KEY)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ShardedBSGSEngine(pub63, a, a + D * 2 * K * w, params, table=table, bitmap=bm,
                            devices=devs)
    if not eng.slices[-1].start <= PUZZLE63_KEY < eng.slices[-1].end:
        fail(f"phase 6a: puzzle 63's key is not in the last shard's slice {eng.slices[-1]}")
    single = bsgs.BSGSEngine(pub63, a, a + D * 2 * K * w, params, device=devs[0], table=table,
                             bitmap=bm)
    _, (host, ev) = eng._sharded_chunk(eng._bases_at(0))
    ev.synchronize()
    rows = host.numpy()[:-1].reshape(D, -1)
    for d, sl in enumerate(eng.slices):
        want = single._chunk_fn(*single._initial_base(sl.step0))[2].cpu().numpy()
        if not np.array_equal(rows[d], want):
            fail(f"phase 6a: shard {d}'s summary of the first sharded chunk differs from the "
                 f"single-device chunk at its slice's base (max_abs_err "
                 f"{int(np.abs(rows[d].astype(np.int64) - want).max())})")
    t0 = time.time()
    found = [f.private_key for f in eng.search_sharded()]
    if found != [PUZZLE63_KEY]:
        fail(f"phase 6a: puzzle-63 recovery over {D} shards failed: {[hex(k) for k in found]}")
    log(f"phase 6a: range-sharded BSGS over {D} shards on {[str(d) for d in devs]} (m=2^"
        f"{m.bit_length() - 1}, U={U}, K={K}, T=1, phase 3d's table, bitmap and bloom2; "
        f"C1={eng.C1}, C2={eng.C2}): the first sharded chunk's {D} summaries word for word "
        f"the single-device chunk at each slice's base; puzzle 63's key (in the last "
        f"shard's slice) found bit-exact in {time.time() - t0:.2f} s")

    eng64 = ShardedBSGSEngine([ecref.scalar_mult(PUZZLE64_KEY)], *PUZZLE64_RANGE, params,
                              table=table, bitmap=bm, devices=devs)
    n, chunks, dt, idle, enq, dec, card = shard_window(eng64, seconds, "phase 6a")
    if (eng64.stats.keys_covered != chunks * D * K * U * eng64.stride
            or n != chunk_launches(eng64, chunks, D)):
        fail(f"phase 6a: the window launched {n} for {chunks} sharded chunks of {D} shards, "
             f"{eng64.stats.keys_covered} keys counted")
    log(f"phase 6a: throughput {chunks} sharded chunks ({D * chunks} shard chunks) in "
        f"{dt:.2f} s -> {eng64.stats.keys_covered / dt:.4e} keys/s (phase 3d's single-device "
        f"search in this run {rate3d:.4e}); device idle share {idle:.4f}; host enqueue "
        f"{enq:.3f} ms a sharded chunk ({enq / D:.3f} a shard chunk) against {card:.3f} ms "
        f"on the card; decode {dec:.3f} ms a decoded one; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {n}; card {card_line()}")
    return n


def phase6b_table(m, table, bm, seconds, devs):
    """Table-sharded BSGS (ShardedTableBSGSEngine) at m = 2^28 over the
    devices, all_gather and ring, sliced from phase 3d's table; returns
    each throughput window's launch counts."""
    import dataclasses
    import gc

    import torch

    from keyhuntm1cpu_tpu_torch.engine import bsgs
    from keyhuntm1cpu_tpu_torch.filter import bitmap as bmp
    from keyhuntm1cpu_tpu_torch.parallel import ShardedTableBSGSEngine
    from keyhuntm1cpu_tpu_torch.ref import ecref

    D, w = len(devs), U * 2 * m
    a = PUZZLE63_KEY - ((D - 1) * 2 * K + K // 2) * w - 12345  # as phase 6a
    b = a + D * 2 * K * w
    pub63 = [ecref.scalar_mult(PUZZLE63_KEY)]
    B = K * U
    sets, counts = {}, {}
    for comm in ("all_gather", "ring"):
        params = dataclasses.replace(bsgs_params(m, "device"), table_comm=comm)
        gc.collect()  # the timing wrappers tie engines in reference cycles
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.time()
        eng = ShardedTableBSGSEngine(pub63, a, b, params, table=table, devices=devs)
        torch.cuda.synchronize()
        t_build = time.time() - t0
        _, n_build = launch_counts()
        per = -(-eng.rows // bmp.TABLE_SLICE)
        if n_build != zero_counts() | dict(insert_keys=D * per * (1 + eng._use_bloom2)):
            fail(f"phase 6b ({comm}): the shard build launched {n_build}")
        _, (host, ev) = eng._sharded_chunk(eng._bases_at(0))
        ev.synchronize()
        rows = host.numpy()[:-1].reshape(D, -1)
        C2 = eng.C2
        sets[comm] = {(d, int(p), int(j), int(j2)) for d, row in enumerate(rows)
                      for p, j, j2 in zip(*row[:3 * C2].reshape(3, C2)) if p < D * B}
        if comm == "all_gather":
            single = bsgs.BSGSEngine(pub63, a, b, bsgs_params(m, "device"), device=devs[0],
                                     table=table, bitmap=bm)
            want = set()
            for d, sl in enumerate(eng.slices):
                out = single._chunk_fn(*single._initial_base(sl.step0))[2].cpu().numpy()
                c2 = single.C2
                want |= {(d * B + int(p), int(j)) for p, *js in zip(*out[:3 * c2].reshape(3, c2))
                         for j in js if p < B and j}
            got = {(p, j) for _, p, *js in sets[comm] for j in js if j}
            if got != want or not got:
                fail(f"phase 6b: the probers' live hits {sorted(got)} differ from the "
                     f"single-device chunks' {sorted(want)}")
            del single
        elif sets["ring"] != sets["all_gather"]:
            fail(f"phase 6b: the ring's first chunk {sorted(sets['ring'])} differs from "
                 f"all_gather's {sorted(sets['all_gather'])}")
        t0 = time.time()
        found = [f.private_key for f in eng.search_sharded()]
        if found != [PUZZLE63_KEY]:
            fail(f"phase 6b ({comm}): puzzle-63 recovery failed: {[hex(k) for k in found]}")
        t_gate = time.time() - t0
        mem = (f"{(torch.cuda.memory_allocated() - base_mem) / 2**30:.2f} GiB of shard "
               f"structures ({D} bitmaps of 2^{eng.shard_bits} bits"
               + (f", {D} bloom2s of 2^{eng.shard_b2_bits}" if eng._use_bloom2 else "")
               + ("; the shards are views of the table)"
                  if all(d == table.key.device for d in devs) else
                  "; the shards are copies on their cards)"))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng64 = ShardedTableBSGSEngine([ecref.scalar_mult(PUZZLE64_KEY)], *PUZZLE64_RANGE,
                                       params, table=table, devices=devs)
        n, chunks, dt, idle, enq, dec, card = shard_window(eng64, seconds,
                                                           f"phase 6b ({comm})")
        # a prober probes once a hop (D hops in the ring, one in all_gather),
        # the ring's summary kernel once a hop and once for its rows
        hops = D if comm == "ring" else 1
        want = zero_counts() | dict(advance_chain=D * chunks, walk_blocks=D * chunks,
                                    probe=D * hops * chunks,
                                    bloom2_compact=D * hops * chunks * eng64._use_bloom2,
                                    chunk_summary=D * (hops + (comm == "ring")) * chunks)
        if eng64.stats.keys_covered != chunks * D * K * U * eng64.stride or n != want:
            fail(f"phase 6b ({comm}): the window launched {n} for {chunks} sharded chunks, "
                 f"{eng64.stats.keys_covered} keys counted")
        counts[comm] = n
        log(f"phase 6b: table-sharded BSGS, {comm}, over {D} shards on "
            f"{[str(d) for d in devs]} ({eng64.rows} rows each; C1={eng64.C1}, "
            f"C2={eng64.C2}): shards built in {t_build:.3f} s (slices, K3 bitmaps and "
            f"blooms), {mem}; "
            + ("the probers' live hits equal the single-device chunks' for each source slice; "
               if comm == "all_gather" else "the first chunk equals all_gather's as a set; ")
            + f"puzzle 63's key found bit-exact in {t_gate:.2f} s; throughput {chunks} sharded "
            f"chunks in {dt:.2f} s -> {eng64.stats.keys_covered / dt:.4e} keys/s; idle share "
            f"{idle:.4f}; host enqueue {enq:.3f} ms a sharded chunk against {card:.3f} ms on "
            f"the card, decode {dec:.3f} ms; peak "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (phase 3d's table, "
            f"bitmap and bloom2 resident); launches {n}")
        del eng64
        gc.collect()
        torch.cuda.empty_cache()
    return counts["all_gather"], counts["ring"]


def phase6c_brute(seconds, devs, rate4):
    """Range-sharded brute force (parallel/brute_mesh.py) in rmd160 at phase
    4's shape; returns the throughput window's launch counts."""
    import torch

    from keyhuntm1cpu_tpu_torch.engine.brute import BruteParams
    from keyhuntm1cpu_tpu_torch.parallel import ShardedBruteEngine
    from keyhuntm1cpu_tpu_torch.ref import ecref
    from keyhuntm1cpu_tpu_torch.utils.targets import TargetSet

    D = len(devs)
    a = BRUTE_RANGE[0]
    span = D * 2 * K * U  # two chunks a shard
    keys = [a + i * (span // 32) + i + 1 for i in range(32)]  # 8 in each shard's slice
    ts = TargetSet(kind="hash160", raw=[brute_artifact("rmd160", ecref.scalar_mult(k))
                                        for k in keys], labels=[hex(k) for k in keys])
    params = BruteParams(block_u=U, steps_per_chunk=K)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = ShardedBruteEngine(ts, a, a + span, mode="rmd160", params=params, devices=devs)
    got = sorted(f.private_key for f in eng.search_sharded())
    if got != keys:
        fail(f"phase 6c: found {len(got)} of the 32 planted keys: {[hex(k) for k in got]}")
    t_gate = time.time() - t0
    eng = ShardedBruteEngine(ts, *BRUTE_RANGE, mode="rmd160", params=params, devices=devs)
    n, chunks, dt, idle, enq, dec, card = shard_window(eng, seconds, "phase 6c")
    if (eng.stats.keys_covered != chunks * D * K * U
            or n != zero_counts() | dict.fromkeys(("advance_chain", "brute_walk_blocks",
                                                   "compact_hits"), D * chunks)):
        fail(f"phase 6c: the window launched {n} for {chunks} sharded chunks, "
             f"{eng.stats.keys_covered} keys counted")
    log(f"phase 6c: range-sharded brute rmd160 over {D} shards on {[str(d) for d in devs]} "
        f"(U={U}, K={K}, T=32): the 32 planted keys (8 a shard) found bit-exact in "
        f"{t_gate:.2f} s; throughput {chunks} sharded chunks in {dt:.2f} s -> "
        f"{eng.stats.keys_covered * eng.stats.multiplier / dt:.4e} effective keys/s (phase 4's "
        f"single-device rmd160 in this run {rate4:.4e}); idle share {idle:.4f}; host enqueue "
        f"{enq:.3f} ms a sharded chunk against {card:.3f} ms on the card; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {n}")
    return n


def phase6de_processes(here):
    """Multihost (6d) and the CLI's --sharded (6e) at m = 2^24, as
    subprocesses started together: two multihost processes joined by a gloo
    rendezvous, each on its slice (the key's owner with its table sharded),
    reporting to a coordinator in this process; the CLI with --sharded range
    and with --sharded table --table-comm ring over 4 shards, each finding
    puzzle 63's key, and --resolve host --sharded, which exits 2."""
    import tempfile

    from keyhuntm1cpu_tpu_torch.dist.coordinator import CoordinatorServer, WorkCoordinator

    w = U * 2 * MH_M
    coord = WorkCoordinator(1, 2, n_units=1)  # the multihost processes' report sink
    srv = CoordinatorServer(("127.0.0.1", 0), coord)
    srv.start_background()
    procs, logs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        pub = pub_file(os.path.join(tmp, "p63.pub"), PUZZLE63_KEY)
        # multihost: 2 slices of 2 chunks, the key in process 1's
        a = PUZZLE63_KEY - (2 * K + K // 2) * w - 777
        mh = ["-m", "keyhuntm1cpu_tpu_torch.dist.multihost", "--coordinator",
              f"127.0.0.1:{free_port()}", "--num-processes", "2", "--report",
              f"127.0.0.1:{srv.server_address[1]}", "-f", pub, "-r",
              f"{a:x}:{a + 4 * K * w:x}", "--m-babies", str(MH_M), "-u", str(U),
              "--chunk-steps", str(K)]
        # the CLI: 4 shards of one chunk, the key in shard 2
        c = PUZZLE63_KEY - (2 * K + K // 2) * w - 999
        cli = ["-m", "keyhuntm1cpu_tpu_torch.cli", "-m", "bsgs", "-f", pub, "-r",
               f"{c:x}:{c + 4 * K * w:x}", "--m-babies", str(MH_M), "-u", str(U),
               "--chunk-steps", str(K), "--n-devices", str(SHARDS)]
        runs = {"mh0": mh + ["--process-id", "0"],
                "mh1": mh + ["--process-id", "1", "--sharded"],
                "range": cli + ["--sharded", "range"],
                "ring": cli + ["--sharded", "table", "--table-comm", "ring"],
                "host": cli + ["--sharded", "--resolve", "host"]}
        t0 = time.time()
        try:
            for name, args in runs.items():
                os.makedirs(os.path.join(tmp, name))
                logs[name] = open(os.path.join(tmp, name, "log"), "w+")
                procs[name] = subprocess.Popen(
                    [sys.executable, *args],
                    cwd=os.path.join(tmp, name), env=subprocess_env(here), stdout=logs[name],
                    stderr=subprocess.STDOUT)
            for p in procs.values():
                p.wait(timeout=600)
        finally:
            for p in procs.values():
                stop_process(p)
            srv.shutdown()
            srv.server_close()
        wall = time.time() - t0
        texts = {}
        for name, f in logs.items():
            f.seek(0)
            texts[name] = f.read()
            f.close()
    rcs = {name: p.returncode for name, p in procs.items()}
    found = [f["private_key"] for f in coord.found_keys()]
    hit = f"{PUZZLE63_KEY:064x}"
    if (rcs != dict(mh0=1, mh1=0, range=0, ring=0, host=2) or found != [f"{PUZZLE63_KEY:x}"]
            or f"FOUND {hit} (process 1)" not in texts["mh1"]
            or any(f"FOUND {hit}" not in texts[n] for n in ("range", "ring"))
            or "--resolve host applies to the single-device engine" not in texts["host"]):
        fail(f"phase 6d/6e: exit codes {rcs}, coordinator's keys {found}; logs:\n"
             + "\n".join(f"[{n}] {t[-2000:]}" for n, t in texts.items()))
    log(f"phase 6d: multihost, 2 processes on the card joined by a gloo rendezvous at "
        f"m=2^{MH_M.bit_length() - 1} (U={U}, K={K}), each on its slice of 2 chunks; process 1 "
        f"(--sharded: its table over its card) found puzzle 63's key, reported once to the "
        f"coordinator; process 0 none (exit 1)")
    log(f"phase 6e: CLI at m=2^{MH_M.bit_length() - 1} over {SHARDS} shards: --sharded range "
        f"and --sharded table --table-comm ring each found puzzle 63's key; --resolve host "
        f"--sharded exited 2; the five processes together in {wall:.1f} s")


def phase7_bench(here):
    """The port's bench entry in a subprocess at BENCH_ENV: rc 0, its last
    stdout line a complete, gated result on this card."""
    import torch

    env = subprocess_env(here) | BENCH_ENV
    t0 = time.time()
    res = subprocess.run([sys.executable, "-m", "keyhuntm1cpu_tpu_torch.bench"], cwd=here,
                         env=env, capture_output=True, text=True, timeout=300)
    lines = res.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1])
    except (IndexError, ValueError):
        line = None
    if res.returncode != 0 or line is None:
        fail(f"phase 7: the bench exited {res.returncode}; stdout tail {lines[-2:]}; stderr "
             f"tail {res.stderr[-3000:]}")
    modes = line["modes"]
    bad = [name for name in BENCH_SECTIONS
           if not str(modes.get(name, {}).get("gate", "")).startswith("ok")
           or not modes[name]["keys_per_sec"] > 0]
    name = smi("name")
    idle = line["device_idle_share"]
    unlaunched = [k for k in BENCH_KERNELS if not line["launches"][k]]
    if (line["gate"] != "ok" or bad or set(modes) != set(BENCH_SECTIONS)
            or not line["value"] > 0
            or line["device"]["name"] not in (name, torch.cuda.get_device_name(0))
            or not (isinstance(idle, float) and 0 <= idle < 1)
            or line["m"] != int(BENCH_ENV["BENCH_M"]) or line["resolve"] != "host"
            or unlaunched):
        fail(f"phase 7: bench line {line}: sections failed or missing {bad}, kernels not "
             f"launched {unlaunched}, card {name!r}")
    log(f"phase 7: the bench ({' '.join(f'{k}={v}' for k, v in BENCH_ENV.items())}) exited 0 "
        f"in {time.time() - t0:.1f} s; every gate ok; its line: {json.dumps(line)}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=1 << 28,
                    help="baby-table size of phases 3 and 3d (default 2^28)")
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="throughput window of phases 3 and 3d")
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
    sys.path.insert(0, os.path.join(here, "scripts"))
    sys.path.insert(0, os.path.join(here, "tests"))  # the kernels' case helpers (numpy only)
    from keyhuntm1cpu_tpu_torch import _build

    card = card_line()
    clock = sm_clock_mhz()
    log(f"phase 0: card {card}; SM clock max {clock:.0f} MHz, now {smi('clocks.sm')}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")
    t0 = time.time()
    _build.kernels()
    t_cuda = time.time() - t0
    t0 = time.time()
    _build.host_lib()
    log(f"phase 0: built CUDA kernels in {t_cuda:.1f} s, native host library in "
        f"{time.time() - t0:.1f} s")
    for ln in ptxas_summary(_build.kernels_build_log()):
        log(f"phase 0: ptxas {ln}")

    results = {}
    phase1_kernels(dev, results, clock)
    phase1_brute(dev, results, clock)
    phase1_minikeys(dev, results, clock)
    phase1_walker(dev, results, clock)
    phase1_bsgs(dev, results, clock)
    phase2_small(dev)
    bsgs, htab, bm, b2 = phase3_main(dev, args.m, args.seconds, results, clock)
    phase3_m30(dev)
    t16_host = phase_t16(dev, args.m, "phase 3", T16_SECONDS, resolve="host", host_table=htab,
                         bitmap=bm, bloom2=b2)
    scheduled = phase3s_scheduled(dev, args.m, SCHED_SECONDS, htab, bm, b2)
    del htab, bm, b2
    torch.cuda.empty_cache()
    device, table, dbm, rate3d = phase3d_device(dev, args.m, args.seconds, clock)
    t16_device = phase_t16(dev, args.m, "phase 3d", T16_SECONDS, resolve="device", table=table,
                           bitmap=dbm)
    phase3b_server(dev, args.m, table)
    fleet = phase3f_fleet(dev, args.m, rate3d, here)
    devs = shard_devices()
    sharded = phase6a_range(args.m, table, dbm, rate3d, SHARD_SECONDS, devs)
    table_ag, table_ring = phase6b_table(args.m, table, dbm, SHARD_SECONDS, devs)
    del table, dbm
    torch.cuda.empty_cache()
    phase3d_large(dev, [m for m in LARGE_M if m > args.m])
    rates4 = {}
    brute = phase4_brute(dev, BRUTE_SECONDS, clock, rates4)
    sharded_brute = phase6c_brute(SHARD_SECONDS, devs, rates4["rmd160"])
    vanity = phase4v_vanity(dev, BRUTE_SECONDS)
    minikeys = phase4b_minikeys(dev, MK_SECONDS)
    phase4r_resume(dev)
    fleet4 = phase4f_fleet(dev)
    walker = phase4c_walker(dev, WK_SECONDS)
    phase5c_cli(dev, args.m, here)
    phase6de_processes(here)
    legacy = phase5l_legacy(dev, X32_M)
    torch.cuda.empty_cache()
    phase7_bench(here)
    paths = dict(bsgs=bsgs, t16_host=t16_host, scheduled=scheduled, device=device,
                 t16_device=t16_device, brute=brute, vanity=vanity, minikeys=minikeys,
                 walker=walker, fleet_workers=fleet, fleet_brute=fleet4["brute"],
                 fleet_minikeys=fleet4["minikeys"], legacy_x32=legacy, sharded_range=sharded,
                 sharded_table_all_gather=table_ag, sharded_table_ring=table_ring,
                 sharded_brute=sharded_brute)
    launches = {name: sum(n[name] for n in paths.values()) for name in bsgs}
    if not all(launches.values()):
        fail(f"a kernel of the main paths never launched: {launches}")
    log(f"phase 5: launches on the main paths {launches} ("
        + ", ".join(f"{k} {v}" for k, v in paths.items()) + ")")

    kernels = [dict(name=name, route="cuda", source=KERNEL_SOURCES[name][0],
                    replaces=KERNEL_SOURCES[name][1], launches=launches[name],
                    **({"library_ms": None} | results[name] | KERNEL_NOTES.get(name, {})))
               for name in launches]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
