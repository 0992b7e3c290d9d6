#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Drives ``repro_torch`` (never the JAX package) through these phases and
prints one JSON object per line:

1. card      — ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build     — builds the seven CUDA kernels from the six sources in
               ``src/repro_torch/kernels/csrc`` (``nvcc``, one process per
               source, all started together) with the ptxas lines of the
               instances the main paths run (registers, spills; for the
               Montgomery kernels both block widths, 8 and 16 columns, with
               the dynamic shared memory a block takes at RSA-2048 width;
               for the column kernels mrc and compare the instances of
               n = 137/138 and of n = 8), and each kernel's static SASS
               opcode counts (``cuobjdump -sass``; for a templated kernel
               the instance the main path runs);
3. parity    — each kernel against its plain torch version on the card, bit
               for bit: mrc, modmul and compare over n in {2, 3, 6, 17, 137,
               200}, bits in {8, 13, 15}, batch in {1, 7, 300, 65537}, int32
               and int64 inputs, and worst-case (m-1)**2 products; mrc and
               compare on channel-major tiles, on the transposed view of
               channels-last rows and on packed (batch, n + 1) rows read in
               place; the codec encode and decode over the codecs
               make(world=1, 8, 512), make(world=8, correct=True) and
               make(world=1, n=8, bits=6), the same batches, the corners
               +-0, +-inf, NaN, +-clip and its neighbours and values that
               clip, and for the decode the extreme sums +-qmax * world;
4. main path — slice 1: the port's quickstart on the card, then Algorithm 1
               (``>=``), the ring product and the ``normalize`` MRC at the
               paper's width (n = 137 15-bit moduli, 2**20 pairs) and on the
               quickstart base (n = 8, 2**22 pairs), checked against the
               plain version on the card, the host big-int oracle on 4096
               sampled columns, and the launch counts the calls imply;
5. codec     — slice 2, the exact gradient all-reduce as the reference's
               train step composes it: three AdamW steps on the gemma3-1b
               parameter tree (999,812,736 f32 elements, seeded step-keyed
               gradients), each ``tree_pack_rns`` -> one int32
               ``all_reduce`` on a one-rank NCCL group -> ``adamw_update``
               with the bucketed decode at its boundary; the decoded
               gradients are held against the f64 oracle and each kernel's
               output against its plain version over the whole buffer, and
               the launches per step must be one encode and one decode.
               Then 8 emulated replicas of one leaf (their summed encodings
               decode to the oracle sum / 8, and one compare launch gives
               the sum's sign), and RRNS repair of injected faults on every
               channel, with a two-channel fault refused;
5b. train    — slice 4, the training path at full width: gemma3-1b
               (999,812,736 f32 parameters) through the port's training
               driver ``repro_torch.launch.train.main``, batch 2 x seq 1024,
               4 steps on the fp32 path, then 4 on ``--rns-allreduce`` (a
               one-rank NCCL group, ``GradCodec.make(world=2)``) from the
               same parameters and batches: finite losses, a per-step loss
               drift under 0.05, exactly one codec_encode and one
               codec_decode launch a step (none on the fp32 path), and on
               step 1 the encode of the real gradient buffer and the decode
               of the summed wire held against their plain versions, bit for
               bit.  Then ``--rns-correct`` with one wire residue corrupted
               at step 2: repaired == 1 there, nothing unrepairable, and the
               parameters after step 4 bit-equal to the same run without
               the fault.  Per step: host ms around a synchronised step,
               tokens/s, CUDA-event ms of forward + backward,
               ``tree_pack_rns``, ``all_reduce`` and ``adamw_update`` with
               its decode; per run the peak device memory beside the
               state's reckoned bytes.  Last the ``rns_gradient_training``
               example at smoke size on the card, then ``train_e2e`` (the
               reference's examples/train_e2e.py: llama3.2-3b cut to 8
               layers, 300 steps on the arith stream): a final loss
               under 3.0, three legacy checkpoints, ms a step;
5e. ckpt     — slice 9, the RRNS checkpointer and resume: gemma3-1b at
               full width cut to CKPT_LAYERS = 6 layers (the host's 45 GiB
               write limit; 27.8 GB of rrns-v1 state) through the training
               driver, fp32: run U, 4 steps uninterrupted; run S, 3 steps
               with ``--save-every 2 --ckpt-keep 1``, one async save of
               params and AdamW state after step 2 written while step 3
               runs; run R, ``--inject-ckpt-corrupt 1`` then resume:
               ``[resume] restored step 2`` with ``repaired_leaves=1``,
               steps 2 and 3, final parameters equal run U's leaf by leaf
               (``tensor_fingerprint``).  The snapshot's ms on the
               training thread, the writer's encode, write + fsync and sha
               seconds, bytes and GB/s, each step's ms (the one with the
               save in flight beside run U's and 5b's median), the
               restore's read, decode, sha and repair seconds, peak host
               RSS and device memory;
5f. mesh     — slice 10, sharding on a (1, 1) DeviceMesh over one NCCL
               rank (``launch.mesh.make_host_mesh``): (a) gemma3-1b at full
               width and depth, parameters, ZeRO-1 moments and batch placed
               by ``dist.sharding``'s spec trees, gradients pinned, 2 fp32
               and 2 codec steps (the wire summed over the mesh's "data"
               group), each step's parameters, moments and loss bit-equal
               to the same step with no mesh, the first codec step's encode
               and decode bit for bit against their plain versions, one
               launch of each a codec step, step ms both ways; (b) the
               paged engine (pages of 512, ``--rns-verify``) on 4 requests
               behind the 1,024-token prefix, 16 new tokens, with
               ``mesh=``: tokens, verify log and the whole pool bit-equal
               to the engine without, decode-step ms both ways; (c) within
               5e, before its directory goes: ``restore(shardings=)`` of
               the rrns-v1 step under the parameter and ZeRO-1 specs,
               bit-equal to its ``device=`` restore, seconds of each; (d)
               ``launch.dryrun`` of gemma3-1b's train_4k and prefill_32k
               cells on the (16, 16) production mesh over a fake group,
               in a subprocess: per-device bytes beside the card's memory,
               prefill_32k's under 80 GB;
5g. flash    — slice 11, the chunked attention routes
               (``models.attention.flash_attention``): gemma3-1b at full
               width and depth (26 layers, 6, 12, 18 and 24 global), f32
               parameters from seed 0, bf16 compute.  (a) ``prefill`` of
               one 32,768-token prompt (the scan route) into a cache of
               33,280 positions, then 16 greedy ``decode_step``s: the
               prefill's ms (CUDA events), launching ops and peak memory,
               each decode step's ms, the 17 logit rows within
               SERVE_LOGIT_TOL of a teacher-forced forward through the
               chunked route (padded to whole chunks); (b) an 8,192-token
               prompt through the chunked and the whole-row routes: the
               last position's logits within 2**-5 of the largest |logit|,
               every token decided by its top-2 margin equal over all
               positions, both prefills' peak memory; (c) the training
               CLI at batch 1 x seq 8192, 2 steps each: fp32 (vjp),
               ``--rns-allreduce`` (one encode and one decode launch a
               step, step 1's kernels bit for bit) and fp32 with
               ``attn_impl="unrolled"``: finite losses, codec drift under
               0.05, the vjp run's update within FLASH_UPDATE_TOL of the
               unrolled run's, step ms and peak memory of each; (d) the
               prefill_32k dry run of 5f;
6. crypto    — slice 3, the RNS crypto lane at RSA-2048 width.  Parity:
               the Montgomery product and ladder-bit kernels against their
               plain versions, bit for bit on every channel, over n_limbs in
               {2, 3, 8, 17, 64, 138} (BASE_MA, and RRNS at 8 and 138),
               batches {1, 7, 300, 4099}, a different N in each column (one
               just below n_max), the operands 0, 1, N-1, N, 2N-1, and bit
               rows all 0, all 1 and mixed.  Main path: ``CryptoEngine``
               with 1024 slots, chunk 8 and ``rns_verify`` on
               ``CryptoContext(n_limbs=138, exp_bits=2048)``, through
               ``run_to_completion``: 1024 non-CRT RSA-2048 private-key
               modexps (odd 2048-bit moduli with the top bit set, 2048-bit
               exponents), 64 modmuls and 4 divmods, every result against
               ``pow``/``divmod`` (run on a process pool), the launch counts
               the calls imply, each divmod's host time, its span between
               two CUDA events and its compare launches, every fingerprint
               verified, and one wire codeword corrupted, detected and
               repaired.  Then ``RNSMontgomery`` modexp/modmul on one
               RSA-2048 N and the ``rns_modmul`` example on the card;
6b. serve    — slice 5, the LLM serve lane at full width: gemma3-1b
               (26 layers, d 1152, vocab 262,144, bf16 compute over f32
               parameters, random weights from seed 0) through the port's
               serve CLI ``repro_torch.launch.serve.main`` (SERVE_ARGS): 8
               slots of 2048 positions, 16 requests of Poisson(1024)-token
               prompts and 64 new tokens, ``--rns-verify`` with one wire
               fault injected.  Checked: every request and token served,
               every ``jit_traces`` value 1, all 16 fingerprints verified
               and the fault detected, repaired and re-verified, exactly one
               codec_encode launch per admission and per retirement, the
               kernel on one real fingerprint against its plain version bit
               for bit; three requests re-run alone through a fresh engine
               give the same tokens and KV rows bit for bit, and again
               through a fresh engine with pow2 prefill buckets (one padded
               extend call a prompt): the chunk loop's tokens and KV rows
               bit for bit, every fingerprint verified; two requests'
               engine logits (the last prompt position and every decode
               step) against a teacher-forced ``train_logits`` over prompt +
               out[:-1], within SERVE_LOGIT_TOL of its largest |logit|, and
               every token whose top-2 margin there exceeds the difference
               equal to the forward's argmax.  Measured (``ServeProbe``):
               wall s and tokens/s, each decode step between CUDA events and
               the host's time to enqueue it, each 256-token prefill chunk,
               TTFT in ticks and ms, a fingerprint (``_fp_impl`` and the
               encode), peak device memory above the run's start.  Then a short ``llm,crypto`` run
               on one engine (SERVE_MIXED_ARGS), every crypto result against
               Python's big ints;
6c. paged    — slice 6, the paged pool, the offline harness and the load
               generator at full width: the same gemma3-1b engine shape
               with pages of 512 tokens (33 pages of 13.6 MB) on a trace
               of 16 requests behind one 1,024-token prefix with their own
               Poisson(256) suffixes and 2 bare-prefix requests, 64 new
               tokens each (``paged_trace``).  (a) ``--mode sim --page-size
               512 --rns-verify --inject-wire-corrupt``: all 18 served,
               every ``jit_traces`` value 1, dedup hits and copy-on-write
               copies above 0, peak pages in use below the pages the same
               slots map without sharing, one codeword a page (the puts
               equal the reader pages less the shared ones plus the
               copies), the injected fault on a retained shared page
               repaired once; then a shared page corrupted under three live
               readers, repaired once, every reader re-verified; the
               codec_encode kernel on a real page fingerprint against its
               plain version bit for bit.  (b) The same trace on the
               batched cache: tokens equal and rids 0, 7 and 16's logical
               K/V rows equal the batched rows bit for bit; the decode step
               and prefill calls of both timed (CUDA events, host clock).
               (c) ``--mode offline --buckets pow2``: the census equal to
               warmup's, every fingerprint verified, wall, tokens/s, TTFT
               and latency in seconds, buckets and paging; whether the
               tokens equal (a)'s and whether rids 0, 7 and 16's logical
               K/V rows equal (a)'s bit for bit (measured, not required),
               and two requests (those whose tokens differ, else rids 7
               and 16) against a teacher-forced forward.  (d)
               SERVE_MIXED_ARGS offline with pages of 256: the 8 crypto
               results against Python's big ints.  (e) ``--mode loadgen``
               (8 requests a phase, QPS 0.5 to 16, two bisections): the
               transcript, every phase free of new signatures.  Each run's
               kernel launches;
6g. warm     — slice 9, warm restart: the paged engine of 6c (pages of
               512, ``--rns-verify``) on 4 requests behind the same
               1,024-token prefix, 16 new tokens each, with
               ``--warm-restart``: the cold run persists its retained
               pages (at least the prefix's 2); one RRNS channel of leaf 0
               of the state is corrupted; the identical second run repairs
               it (``ckpt_repaired_leaves`` 1), adopts every page (one
               codec_encode launch each, revalidating), drops none, dedups
               against them and gives the cold run's tokens bit for bit.
               The pool reckoned beside the bytes written; the seconds of
               ``save_warm_state`` and ``load_warm_state``;
6h. replicas — slice 12, offline replicas over ranks: REPLICA_ARGS
               (gemma3-1b at full width and depth, bf16 compute,
               ``--rns-verify``, 4 slots of 2048 a replica, pow2 buckets, 8
               Poisson(512) prompts with 32 new tokens, all at t = 0)
               through the serve CLI in 2 processes on the one card with
               torchrun's environment: a gloo world of 2 for the
               controller's exchanges, ``--replicas 2`` of one rank each
               (a one-rank NCCL group a replica).  Each process writes its
               result and log under chiprun_out/replicas/; one that fails
               fails the phase.  Required: every request served once,
               every fingerprint verified, the census unchanged on both
               ranks, and rank 0's tokens for every rid and ``dispatched``
               equal to the one-process ``OfflineInference(replicas=2)``'s
               on the same card and workload.  Measured: wall s and
               tokens/s of both, the exchange's host ms a tick (median,
               p99) on each rank, each process's peak device memory;
5c. moe train — slice 7, after a check that TF32 is off for f32 matmuls
               (the MoE router's expert choice): qwen2-moe-a2.7b at full
               width cut to 2 layers through the training CLI, batch 2
               x seq 1024, 3 fp32 steps and 3 ``--rns-allreduce`` steps
               from one seed: finite losses, every step's aux loss
               reported, one encode and one decode launch a codec step,
               step 1's encode and decode bit for bit against the plain
               versions, the codec's loss drift under 0.05 a step;
5d. families — slice 8: mamba2-370m, zamba2-1.2b and whisper-tiny at full
               width and depth through the training CLI (batch 2 x seq
               1024, 8 SSD chunks of 128; whisper seq 448), 3 fp32 and 3
               ``--rns-allreduce`` steps (zamba2 and whisper 2 and 2) from
               one seed: finite losses, one encode and one decode launch a
               codec step, step 1's encode and decode bit for bit against
               the plain versions, the codec's drift under 0.05 a step;
               then the README's ``--rns-correct --inject-corrupt-step 2``
               on mamba2 (3 steps): one value repaired, nothing
               unrepairable, the parameters bit-equal to the run without
               the fault.  Step ms, tokens/s and peak memory of each run;
6d. moe serve — qwen2-moe-a2.7b at full width and depth (14,004,422,656
               f32 parameters) through the serve CLI on 6b's engine shape
               and workload: every request served and fingerprint
               verified, the injected fault repaired, one encode launch per
               admission and per retirement, the kernel on a real
               fingerprint bit for bit; rids 0, 7 and 15 alone equal to the
               packed run bit for bit (tokens, K/V rows).  A no-drop run of
               two requests through the engine API at capacity factor E/K
               (every call's capacity checked to hold its tokens) against a
               teacher-forced forward within SERVE_LOGIT_TOL.  6c's
               shared-prefix trace on the paged pool and on the batched
               cache: tokens and rids 0, 7 and 16's logical K/V rows equal
               bit for bit; then ``--mode offline --buckets pow2``: the
               census equal to warmup's, the tokens that differ from the
               chunk loop counted (bucketed chunks change the capacity).
               Decode step and prefill call times, tokens/s and peak
               memory of each run;
6e. vlm      — internvl2-26b at full width cut to 12 of 48 layers through
               the serve CLI, which falls back to single-shot serving (4
               requests of 512 and 1,024-token prompts behind 1,024 patch
               embeddings, 16 new tokens; the prefill takes whole
               512-token chunks): each request's logits against a
               teacher-forced forward with the same patches, within
               SERVE_LOGIT_TOL;
6f. families — mamba2-370m and zamba2-1.2b at full width and depth through
               the serve CLI, which falls back to single-shot serving, on
               a trace it writes to chiprun_out/ssm_trace.jsonl (prompts
               of 128, 256, 512 and 1,024 tokens, whole SSD chunks, 32 new
               tokens each), and whisper-tiny on 4 Poisson(64) prompts with
               frames drawn per request: every request served, its logits
               against a teacher-forced forward (padded at the end to a
               multiple of 512) within SERVE_LOGIT_TOL in bf16 compute, or,
               where a request breaks it there, in f32 compute with the
               bf16 distances reported; tokens/s, decode step ms (CUDA
               events) and peak memory;
7. timing    — CUDA-event medians of each kernel and its plain version at
               the main-path shapes: ``ms`` is one launch between two
               events, the wrapper's host work before the launch included;
               for the column and Montgomery kernels also ten back to back,
               per launch (``ms_back_to_back``), and ten queued behind a
               sleep on the card, so that the events time the card alone
               (``ms_device``).  Beside each, its bound: the largest of
               bytes over 3.35 TB/s (H100 SXM data sheet) and, for each pipe
               (int32, conversion, fp32, load/store, int8 tensor cores), the
               work on it over that pipe's peak rate — for mrc, compare and
               the Montgomery kernels the work the function needs at the
               fewest instructions an exact step takes (``column_work``,
               ``mont_mix``), for the others as their source issues it.  mrc
               and compare at paper_n137, quickstart_n8 and on one column of
               the lane's n = 138 base (the divmod's packed rows), with a
               latency floor for that column: its 137 dependent steps at the
               cheapest step's time, the slope of one-column device times
               between n = 17 and 32; the Montgomery kernels at 8,192
               columns, at 1,024 (the lane's ladder) and on one column (the
               lane's other products).  To time a parent commit beside
               this tree, run both trees' chip_smoke.py in one call to the
               card (parent, change, change, parent) and read the rows;
8. kernels   — one line listing every ported kernel, its launches summed
               over the main paths (slice 1, the codec steps, the
               full-width training runs, the crypto lane, the serve runs,
               the paged runs, the warm restart runs, the replica ranks of
               6h, the moe training and serve runs, the ssm, hybrid and
               encdec training runs; the
               checkpointed training runs and train_e2e launch none) and
               one
               timing
               row: mrc and modmul at the
               paper's width, compare on the one column where 17,588 of its
               17,657 launches run (the divmods' and the canonicalisations'
               shape), the codec's on the gemma3-1b buffer, the Montgomery
               kernels at the 8,192-column timing shape (the lane runs the
               ladder on 1,024 columns and its products on one; those rows
               are in phase 7).

The last line is ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero with no ``ok`` line; so does a host without a CUDA device, or
a directory without the repository's ``src/``.  Everything printed to
standard output is also written to ``chiprun_out/chip_smoke.out``, whole.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import gc
import json
import math
import multiprocessing
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
from collections import Counter
from concurrent.futures import ProcessPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
# H100 SXM dense int8 tensor-core rate (data sheet), operations per second:
# the Montgomery kernels' base-extension dots run as u8 products there.
INT8_TENSOR_OPS_PER_S = 1.979e15
# Peak instructions per clock per SM for compute capability 9.0, by pipe:
# the CUDA C++ Programming Guide's arithmetic-throughput table (32-bit
# integer add/compare/multiply-add 64, conversions between 32-bit integer
# and float 16, fp32 128) and the SM's 32 load/store units (shared and
# global accesses alike).  Times the card's SM count and maximum SM clock,
# both read in this run, each gives that pipe's peak; at 132 SMs and
# 1.98 GHz the fp32 pipe with FMA counted twice is the data sheet's
# 67 TFLOP/s.
PIPE_PER_SM_CLOCK = {"int32": 64, "conversion": 16, "fp32": 128,
                     "load/store": 32}
# Instructions each unit of work issues, by pipe, counted from
# src/repro_torch/kernels/csrc/common.cuh.  Address arithmetic is not
# counted, so each pipe's count is a floor.
SUB_MOD = Counter({"int32": 3})             # a - b, compare, add m
# (a * b) mod m: product, f32 quotient (int->float, multiply, float->int),
# t - q*m, and the two corrections (compare and add each).  The SASS for
# sm_90a holds the int->float as I2FP, not the I2F that the 16-per-clock
# conversion rate is given for; it is counted on the int32 pipe, an
# assumption about its rate.  The float->int (F2I) is a conversion.
MUL_MOD = Counter({"int32": 7, "conversion": 1, "fp32": 1})
# The gradient codec (csrc/codec_encode.cu, csrc/codec_decode.cu).
# MULHI_MOD: t mod m by the multiply-high step (high product, t - q*m, one
# compare and subtract).  EMBED: the signed embedding of one channel (the
# negated residue: compare, subtract, select; the shift: add, compare,
# subtract; the final select).
MULHI_MOD = Counter({"int32": 4})
EMBED = Counter({"int32": 7})
ORACLE_COLUMNS = 4096
# 200: the column kernels' instance with 14 register slots a lane (n > 160)
SWEEP_NS, SWEEP_BITS = (2, 3, 6, 17, 137, 200), (8, 13, 15)
SWEEP_BATCHES = (1, 7, 300, 65537)
PAPER_BATCH, SMALL_BATCH = 1 << 20, 1 << 22
DEVICE = "cuda"

# Slice 2, the gradient codec.  Its main path runs on the parameter tree of
# gemma3-1b as the port builds it (``model_tree``: the shapes of
# ``repro_torch.models.abstract_params``, the reference's tree): 10 f32
# leaves, 999,812,736 elements.
MODEL_NAME = "gemma3_1b"
CODEC_STEPS = 3
CODEC_SWEEP = (dict(world=1), dict(world=8), dict(world=512),
               dict(world=8, correct=True), dict(world=1, n=8, bits=6))
REPLICAS = 8                       # the detect codec is make(world=8)
REPLICA_LEAF = "layers/attn/wq"    # 30,670,848 elements
CLIP_STRIDE = 1_000_003            # every such element is scaled past the clip
CHUNK = 1 << 26                    # elements per plain-version comparison
DIST_BACKEND = "nccl"

# Slice 4, the training path: gemma3-1b at full width through the port's
# training driver (``repro_torch.launch.train.main``), batch 2 x seq 1024,
# past the 512-token window of 5 layers in 6; every run from the same
# ``init_params`` seed and the same ``SyntheticLM`` batches.
TRAIN_ARGS = ("--arch", "gemma3-1b", "--no-smoke", "--batch", "2",
              "--seq", "1024", "--steps", "4")
TRAIN_CHECK_STEP = 1      # the RNS run's step held against the plain versions
TRAIN_INJECT_STEP = 2     # the --rns-correct run's corrupted step
TRAIN_MAX_DRIFT = 0.05    # examples/rns_gradient_training.py's own limit

# Slice 9, the checkpointer and warm restart.  Phase 5e checkpoints phase
# 5b's fp32 run at full width, cut to CKPT_LAYERS layers (one of gemma3's
# groups of 5 local and 1 global layer): 463,026,816 parameters, whose
# rrns-v1 state (params and AdamW's m and v, 4 bytes each, 5 int32
# residues per 4 bytes) is 27.8 GB on disk.  Full depth would be 60.0 GB,
# more than the 45 GiB that the card's host lets one run of this script
# write (it counts every byte written, deleted or not); tools/ckpt_probe.py's rates
# there (0.98 GB/s written and fsynced, 3.4 GB/s read, sha256 1.41 GB/s a
# thread) would have allowed it.  Run U trains TRAIN_ARGS' steps at the
# cut without a checkpoint; run S saves once, asynchronously, after step 2
# of 3; run R corrupts one RRNS channel of it, restores it and runs steps
# 2 and 3, and must end equal to run U.  Both write under CKPT_DIR in the
# checkout (git-ignored), removed after the phase.  Phase 6g runs the
# paged engine twice on WARM_SHARED requests behind the paged trace's
# 1,024-token prefix, persisting and adopting its pool under WARM_DIR.
RUN_WRITE_LIMIT = 45 << 30     # bytes one run may write on the card's host
CKPT_DIR = os.path.join(ROOT, "_ckpt_smoke")
CKPT_LAYERS = 6
CKPT_SAVE_STEPS = 3
CKPT_SAVE_FLAGS = ("--save-every", "2", "--ckpt-keep", "1")
CKPT_SAVED_STEP = 2
CKPT_CHANNELS = 5          # 3 base + 2 redundant residues per uint32 limb
E2E_DIR = os.path.join(CKPT_DIR, "train_e2e")
WARM_DIR = os.path.join(CKPT_DIR, "warm")
WARM_SHARED, WARM_MAX_NEW = 4, 16
# Slice 10, sharding (phase 5f): a (data 1, model 1) mesh over one NCCL
# rank on the card (make_host_mesh).  (a) gemma3-1b at full width and
# depth, batch 2 x seq 1024, placed by the spec trees (ZeRO-1 moments,
# gradients pinned): MESH_FP32_STEPS fp32 then MESH_CODEC_STEPS codec
# steps, each beside the same step with no mesh; (b) phase 6g's paged
# engine on WARM_SHARED requests behind the prefix, with and without
# ``mesh=``; (c) inside 5e, its rrns-v1 step restored onto the mesh; (d)
# the dry run of gemma3-1b's train_4k cell on the (16, 16) mesh over a
# fake group, in a process of its own.
MESH_ARCH = "gemma3-1b"
MESH_BATCH, MESH_SEQ = 2, 1024
MESH_FP32_STEPS, MESH_CODEC_STEPS = 2, 2
MESH_DRYRUN = ("--arch", "gemma3-1b", "--shape", "train_4k", "--mesh",
               "single")
FLASH_DRYRUN = ("--arch", "gemma3-1b", "--shape", "prefill_32k", "--mesh",
                "single")
WARM_ARGS = ("--page-size", "512", "--rns-verify")

# Slice 3, the crypto lane at RSA-2048 width: CryptoContext(n_limbs=138,
# exp_bits=2048) — 138 15-bit moduli a side (M, M' of 2062 bits), nch_lo =
# 139 B-side channels with m_a, n_hi = 138.  The 137 moduli of
# configs/paper_rns.py do not fit a 2048-bit N (M' > 2N fails).
CRYPTO_LIMBS, CRYPTO_EXP_BITS, RSA_BITS = 138, 2048, 2048
CRYPTO_SLOTS, CRYPTO_CHUNK = 1024, 8
# One divmod at this width is 2 * 2062 + 1 Algorithm-1 comparisons on one
# column, each a one-column compare launch of 0.057 ms (PERF.md §6, NVIDIA
# H100 80GB HBM3 at 700 W); a divmod is host-bound, 1.0-2.1 s of torch ops
# around those launches, so the lane takes 4, not 64.
CRYPTO_MODEXPS, CRYPTO_MODMULS, CRYPTO_DIVMODS = 1024, 64, 4
CRYPTO_SWEEP_LIMBS, CRYPTO_RRNS_LIMBS = (2, 3, 8, 17, 64, 138), (8, 138)
CRYPTO_BATCHES = (1, 7, 300, 4099)
CRYPTO_TIMING_BATCH = 8192
CRYPTO_SHAPE = "rsa2048_n138"
# The Montgomery kernels are also timed at the lane's width (CRYPTO_SLOTS
# columns: its ladder bits) and on one column (its admits, retirements and
# modmuls, and RNSMontgomery's ladder), and the compare kernel on one column
# of the lane's base, the shape of a divmod's Algorithm-1 steps.
CRYPTO_LANE_SHAPE = "rsa2048_n138_lane"
CRYPTO_ONE_SHAPE = "rsa2048_n138_one"
DIVMOD_SHAPE = "divmod_n138"
# Bases whose one-column compare times give the time of the triangle's
# cheapest step (one register slot a lane: 16 < n <= 32), for the latency
# floor of the divmod's column.
FLOOR_NS = (17, 32)
# Slice 5, the LLM serve lane: gemma3-1b at full width through the port's
# serve CLI (``repro_torch.launch.serve.main``), 8 slots of 2048 positions,
# 16 requests of Poisson(1024)-token prompts (past the 512-token window of
# 5 layers in 6) and 64 new tokens each, RRNS fingerprints verified and one
# wire fault injected, random weights from seed 0.
SERVE_ARGS = ("--arch", "gemma3-1b", "--no-smoke", "--slots", "8",
              "--cache-len", "2048", "--prefill-chunk", "256",
              "--requests", "16", "--prompt-mean", "1024", "--max-new", "64",
              "--arrival-rate", "0.5", "--rns-verify",
              "--inject-wire-corrupt", "--seed", "0", "--device", DEVICE)
SERVE_SOLO_RIDS = (0, 7, 15)   # re-run alone: batching invariance
SERVE_CHECK_RIDS = (7, 15)     # held against a teacher-forced forward
# the engine's bf16 logits against the forward's: at most this share of the
# forward's largest |logit| apart (bf16 rounds each at 2**-8 relative, and
# the chunked prefill and the decode steps round other products than one
# forward over the whole sequence does)
SERVE_LOGIT_TOL = 2.0 ** -4
# both families on one engine, on a smaller LLM workload
SERVE_MIXED_ARGS = ("--arch", "gemma3-1b", "--no-smoke", "--slots", "4",
                    "--cache-len", "512", "--prefill-chunk", "128",
                    "--requests", "4", "--prompt-mean", "200",
                    "--max-new", "8", "--arrival-rate", "0.5",
                    "--families", "llm,crypto", "--crypto-slots", "4",
                    "--crypto-requests", "8", "--crypto-limbs", "8",
                    "--crypto-exp-bits", "32", "--rns-verify", "--seed", "1",
                    "--device", DEVICE)
# Slice 6, the paged pool (phase 6c): gemma3-1b at full width on the same
# engine shape (8 slots x 2048 positions, chunk 256) with pages of 512
# tokens (default pool: 1 + 8 * 4 = 33 pages of 13.6 MB), on a trace of
# shared-prefix traffic (``paged_trace``): 16 requests whose prompts share
# one 1,024-token prefix, each with its own Poisson(256) suffix, then 2
# requests of the bare prefix (full-prefix hits: copy-on-write), 64 new
# tokens each, arrivals at 0.5 a tick; seed 0.
PAGED_PREFIX, PAGED_SHARED, PAGED_BARE = 1024, 16, 2
PAGED_SUFFIX_MEAN, PAGED_MAX_NEW, PAGED_RATE = 256, 64, 0.5
PAGED_ENGINE = ("--arch", "gemma3-1b", "--no-smoke", "--slots", "8",
                "--cache-len", "2048", "--prefill-chunk", "256",
                "--seed", "0", "--device", DEVICE)
PAGED_SIM = ("--page-size", "512", "--rns-verify", "--inject-wire-corrupt")
PAGED_MONO = ("--rns-verify",)
PAGED_OFFLINE = ("--mode", "offline", "--page-size", "512", "--buckets",
                 "pow2", "--rns-verify")
PAGED_ROW_RIDS = (0, 7, 16)        # logical K/V rows, paged == batched
# SERVE_MIXED_ARGS' workload (cache 512) offline, in pages of 256
PAGED_MIXED = ("--mode", "offline", "--page-size", "256", "--buckets", "pow2")
PAGED_LOADGEN = PAGED_ENGINE + (
    "--mode", "loadgen", "--page-size", "512", "--qps-lo", "0.5",
    "--qps-hi", "16", "--qps-iters", "2", "--phase-requests", "8",
    "--prompt-mean", "256", "--max-new", "16")
# Phase 6h, offline replicas over ranks: two processes on the one card
# with torchrun's environment, a gloo world of 2 for the controller's
# exchanges and replicas = 2 of one rank each (a one-rank NCCL group a
# replica: NCCL refuses two ranks of one communicator on one card);
# gemma3-1b at full width and depth, bf16 compute, 4 slots of 2048 a
# replica, pow2 buckets as in 6c, 8 Poisson(512) prompts with 32 new
# tokens, all at t = 0; seed 0.
REPLICA_WORLD = 2
REPLICA_ARGS = ("--arch", "gemma3-1b", "--no-smoke", "--slots", "4",
                "--cache-len", "2048", "--prefill-chunk", "256",
                "--requests", "8", "--prompt-mean", "512", "--max-new",
                "32", "--seed", "0", "--mode", "offline", "--buckets",
                "pow2", "--replicas", "2", "--rns-verify", "--device",
                DEVICE)
REPLICA_TIMEOUT = 300      # seconds a rank's process may take
# Slice 7, the moe and vlm families.  qwen2-moe-a2.7b (hf:Qwen/Qwen1.5-MoE-
# A2.7B: 24 layers, d 2048, 16 heads, 60 routed experts top-4 of ff 1408
# plus 4 shared, vocab 151,936; 14,004,422,656 f32 parameters, 56.0 GB) at
# full width and depth on phase 6b's engine shape and workload, and on
# phase 6c's shared-prefix trace; trained at full width cut to 2 layers
# (1.45e9 parameters: the codec path's state and wire fit one card).
# internvl2-26b (d 6144, 48 heads, 8 KV heads, ff 16,384, 1,024 patch
# embeddings) at full width cut to 12 of 48 layers (5.25e9 parameters,
# 21 GB: 77.2 GB of f32 parameters at full depth leave no room for a run)
# through the serve CLI's single-shot path.
MOE_ARCH, VLM_ARCH = "qwen2-moe-a2.7b", "internvl2-26b"


def with_flag(args: tuple, flag: str, value: str) -> tuple:
    i = args.index(flag) + 1
    return args[:i] + (value,) + args[i + 1:]


def with_arch(args: tuple, arch: str) -> tuple:
    return with_flag(args, "--arch", arch)


MOE_SERVE_ARGS = with_arch(SERVE_ARGS, MOE_ARCH)
MOE_ENGINE = with_arch(PAGED_ENGINE, MOE_ARCH)
MOE_TRAIN_ARGS = ("--arch", MOE_ARCH, "--no-smoke", "--batch", "2",
                  "--seq", "1024", "--steps", "3")
MOE_TRAIN_LAYERS = 2
# Prompts of whole 512-token chunks: with the 1,024 patches ahead of them
# the prefill is a whole number of attention chunks, the only length the
# chunked attention takes (the reference's assert); written as a trace
# (``chunk_trace``) to chiprun_out/vlm_trace.jsonl.
VLM_PROMPTS = (512, 1024, 512, 1024)
VLM_MAX_NEW = 16
VLM_ARGS = ("--arch", VLM_ARCH, "--no-smoke", "--trace",
            os.path.join(ROOT, "chiprun_out", "vlm_trace.jsonl"), "--seed",
            "0", "--device", DEVICE)
VLM_LAYERS = 12
# Slice 8, the ssm, hybrid and encdec families (phases 5d and 6f), each at
# full width and depth: mamba2-370m (48 layers, d 1024, 32 SSD heads, state
# 128, chunk 128; 368,363,008 parameters), zamba2-1.2b (38 Mamba2 layers,
# d 2048, state 64, one shared attention+MLP block after every 6;
# 1,104,937,856) and whisper-tiny (4 + 4 layers, d 384, 1,536 stub frames;
# 41,197,824).  Trained at batch 2 x seq 1024 (8 SSD chunks), whisper at
# Whisper's decoder context of 448; served single-shot, mamba2 and zamba2
# on a trace of prompts of whole chunks (the reference's prefill takes no
# other length), whisper on Poisson(64) prompts with frames per request.
SSM_ARCH, HYBRID_ARCH, ENCDEC_ARCH = ("mamba2-370m", "zamba2-1.2b",
                                      "whisper-tiny")
FAMILY_TRAIN_ARGS = {
    SSM_ARCH: ("--arch", SSM_ARCH, "--no-smoke", "--batch", "2", "--seq",
               "1024", "--steps", "3"),
    HYBRID_ARCH: ("--arch", HYBRID_ARCH, "--no-smoke", "--batch", "2",
                  "--seq", "1024", "--steps", "2"),
    ENCDEC_ARCH: ("--arch", ENCDEC_ARCH, "--no-smoke", "--batch", "2",
                  "--seq", "448", "--steps", "2"),
}
SSM_PROMPTS = (128, 256, 512, 1024)   # the trace's prompt lengths
SSM_MAX_NEW = 32
ENCDEC_SERVE_ARGS = ("--arch", ENCDEC_ARCH, "--no-smoke", "--requests", "4",
                     "--prompt-mean", "64", "--max-new", str(SSM_MAX_NEW),
                     "--seed", "0", "--device", DEVICE)
# Slice 11, the chunked attention routes (phase 5g): gemma3-1b at full
# width and depth (26 layers, of which 6, 12, 18 and 24 are global), f32
# parameters from seed 0, bf16 compute.  (a) ``models.prefill`` (the scan
# route) of one FLASH_PROMPT-token prompt into a cache of FLASH_CACHE
# positions, then FLASH_DECODE greedy decode steps (decode_32k's shape at
# batch 1), against a teacher-forced forward through the chunked route;
# (b) a FLASH_AGREE-token prompt through the chunked and the whole-row
# routes; (c) the training CLI at batch 1 x FLASH_AGREE, 2 steps each:
# fp32 (the vjp route), --rns-allreduce, and fp32 on the unrolled route;
# (d) within 5f's dry run, the prefill_32k cell.
ATTN_CHUNK = 512          # the models' attention chunk: longer inputs pad to it
FLASH_ARCH = "gemma3-1b"
FLASH_PROMPT, FLASH_CACHE, FLASH_DECODE = 32768, 33280, 16
FLASH_AGREE = 8192
FLASH_AGREE_TOL = 2.0 ** -5   # test_torch_models.py's bf16 bound
FLASH_TRAIN_ARGS = ("--arch", FLASH_ARCH, "--no-smoke", "--batch", "1",
                    "--seq", str(FLASH_AGREE), "--steps", "2")
# The vjp run's update against the unrolled run's, after the last step:
# |theta_vjp - theta_unrolled| / |theta_unrolled - theta_0| (L2 over every
# parameter).  Both backward passes are exact to rounding, but AdamW's
# first steps move each weight by about lr * sign(g), so a weight whose
# gradient sits within the rounding of 0 moves the other way; a wrong
# backward moves most weights the other way (a ratio near 1 or above).
FLASH_UPDATE_TOL = 0.25
ORACLE_CHUNK = 16                  # pow() calls per process-pool task
# Card cycles to sleep before a queued timing: longer than the host takes to
# enqueue ten launches of any kernel timed (about 2 ms at 1.98 GHz).
QUEUE_CYCLES = 4_000_000


@functools.lru_cache(maxsize=None)
def model_tree() -> dict:
    """{leaf name: shape} of gemma3-1b's parameters, in the wire buffer's
    leaf order, from the port's ``abstract_params`` (nothing allocated)."""
    from repro_torch.configs import get_config
    from repro_torch.dist._tree import flatten_named
    from repro_torch.models import abstract_params

    return {name: tuple(leaf.shape) for name, leaf in
            flatten_named(abstract_params(get_config("gemma3-1b")))}


def median_ms(fn, runs=20, warmup=3, inner=1, queued=False):
    """Median over ``runs`` of the time between two CUDA events around
    ``inner`` calls, per call.  With ``inner`` = 1 the time includes the
    host work of the call before its launch (the card waits for it); back
    to back, that work overlaps the previous launch.  ``queued``: the
    launches are enqueued behind a sleep on the card, so the events time the
    card alone (device time, no host work)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Tee:
    """Standard output copied, line for line, into a file."""

    def __init__(self, stream, path: str):
        self.stream, self.file = stream, open(path, "w")

    def write(self, text: str) -> int:
        self.file.write(text)
        return self.stream.write(text)

    def flush(self) -> None:
        self.file.flush()
        self.stream.flush()


def free_card() -> None:
    """Return what the earlier phases dropped to the card: collect Python's
    cycles, then release the allocator's cached blocks."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def scaled(mix: Counter, k: int) -> Counter:
    return Counter({pipe: k * c for pipe, c in mix.items()})


def column_mix(name: str, n: int) -> Counter:
    """Instructions by pipe for one element of modmul, codec_encode or
    codec_decode, as its source in csrc/ issues them; n counts the channels
    (for the encode, those written)."""
    steps = n * (n - 1) // 2
    if name == "codec_encode":
        # g in; scale, NaN test and select, sign, |r| min 2**44, 2**-15
        # scale, limb split (fp32); rint, floor and two float->int
        # (conversion); the clip (int32); per channel MULHI_MOD, the
        # Barrett step MUL_MOD, EMBED and the store
        return (Counter({"load/store": 1, "fp32": 8, "conversion": 4,
                         "int32": 6})
                + scaled(MULHI_MOD + MUL_MOD + EMBED
                         + Counter({"load/store": 1}), n))
    if name == "codec_decode":
        # per channel a load and the fold (MUL_MOD without its product);
        # the MRC steps in registers; Horner (three multiply-adds, two
        # shifts, three masks per step); the signed fold with borrows and
        # three int->float (int32, as I2FP); Fast2Sum and the scale
        # (fp32); the store
        return (Counter({"load/store": 1, "fp32": 7, "int32": 20})
                + scaled(MUL_MOD - Counter({"int32": 1})
                         + Counter({"load/store": 1}), n)
                + scaled(SUB_MOD + MUL_MOD, steps)
                + scaled(Counter({"int32": 8}), n - 1))
    # modmul: x, y, m in, out; 1/m from an int->float (I2FP)
    return MUL_MOD + Counter({"load/store": 4, "int32": 1})


# One step of an MRC triangle, (w_i - a) * inv mod m_i, at the fewest
# instructions an exact step is known to take (csrc/mont_ladder.cu,
# mrc_warp): a three-input add, the product, the int->float (I2FP, counted
# on the int32 pipe as above), one FFMA that rounds the quotient, and the
# multiply-add that leaves the lazy remainder.
MRC_LAZY_STEP = Counter({"int32": 4, "fp32": 1})


def column_work(name: str, n: int) -> Counter:
    """The work one column of mrc or compare takes, by pipe, whatever the
    implementation (the way mont_mix counts the Montgomery kernels): the
    triangle's n(n-1)/2 steps at MRC_LAZY_STEP; for compare also the n
    channel-wise subtractions (SUB_MOD), the dot's n terms each reduced
    lazily (MRC_LAZY_STEP) and summed (one add each), one final reduction
    of the sum (MUL_MOD) and the verdict (SUB_MOD and the equality).  No
    load or store: each operand's bytes count once, in column_bytes, and
    no kernel's own shared-memory traffic is work the function needs."""
    tri = scaled(MRC_LAZY_STEP, n * (n - 1) // 2)
    if name == "mrc":
        return tri
    return (tri + scaled(SUB_MOD, n)
            + scaled(MRC_LAZY_STEP + Counter({"int32": 1}), n)
            + MUL_MOD + SUB_MOD + Counter({"int32": 1}))


def column_bytes(name: str, n: int, B: int, image: int) -> int:
    """Bytes mrc or compare must move: each operand read once (mrc n int32
    residues a column; compare 2 n and the two m_a residues), each output
    written once (n int32 digits; a one-byte verdict, the kernel's
    torch.bool), and the table image once."""
    if name == "mrc":
        return 8 * n * B + image
    return 4 * (2 * n + 2) * B + B + image


def mont_mix(name: str, n: int, nch_lo: int, n_hi: int) -> Counter:
    """The work one column of the Montgomery kernels' function takes, by
    pipe, whatever the implementation: the two MRC triangles' n(n-1)/2 +
    n_hi(n_hi-1)/2 modular steps (MRC_LAZY_STEP each); the channel-wise
    products as f32 Barrett steps (q: 2n; x'y', q'N, t M^-1: 3 n_hi; the
    add and correction of t); the base-extension dots' n n_hi + n_hi
    nch_lo terms at the int8 tensor-core rate, four u8 products (8
    operations) a term, and the exact reduction of each of their n_hi +
    nch_lo sums (three multiply-high steps and the shifts and adds).  n
    base channels of B, nch_lo B-side channels with the redundant ones,
    n_hi of B'."""
    prod = (scaled(MRC_LAZY_STEP, n * (n - 1) // 2 + n_hi * (n_hi - 1) // 2)
            + scaled(MUL_MOD, 2 * n + 3 * n_hi)
            + scaled(Counter({"int32": 3}), n_hi)
            + Counter({"int8_tensor": 8 * (n * n_hi + n_hi * nch_lo)})
            + scaled(scaled(MULHI_MOD, 3) + Counter({"int32": 4}),
                     n_hi + nch_lo))
    if name == "mont_mul":
        return prod
    # ladder: two products and three selects (xor, and, xor) over both
    # bases, and the mask (2)
    return scaled(prod, 2) + Counter({"int32": 9 * (nch_lo + n_hi) + 2})


def mont_bytes(name: str, n: int, nch_lo: int, n_hi: int, B: int,
               image: int) -> int:
    """Bytes the Montgomery kernels must move: each operand read once (the
    B-side inputs' n base channels, the only ones the function reads), each
    output written once, and the table image once."""
    if name == "mont_mul":
        return 4 * B * (2 * (n + n_hi) + n + n_hi + nch_lo + n_hi) + image
    return 4 * B * (2 * (n + n_hi) + 1 + n + n_hi
                    + 2 * (nch_lo + n_hi)) + image


# "/*0070*/  @!P0 IMAD.MOV.U32 R1, ..." -> "IMAD"
SASS_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)")


KERNEL_NAMES = ("mrc_thread_kernel", "mrc_warp_kernel", "modmul_kernel",
                "compare_thread_kernel", "compare_warp_kernel",
                "codec_encode_kernel", "codec_decode_kernel",
                "mont_mul_kernel", "mont_ladder_kernel")
# The codec kernels are templates on their channel count; the build and
# SASS lines show the instance the main path runs (4 channels written by
# the encode, 3 base channels read by the decode), "_Z...ILi4E..." mangled.
# The Montgomery kernels are templates on the columns a block holds: 8 on
# the lane's 1,024 columns (the SASS census shows that one), 16 from 2,112
# columns on (the timing shape).  The column kernels (mrc, compare) come
# in two mappings: a warp a column, a template on the register slots a lane
# (5 at n = 137 and 138), and a thread a column, a template on n (8 on the
# quickstart base).
MAIN_INSTANCE = {"codec_encode_kernel": ((4,),), "codec_decode_kernel": ((3,),),
                 "mont_mul_kernel": ((8,), (16,)),
                 "mont_ladder_kernel": ((8,), (16,)),
                 "mrc_warp_kernel": ((5,),), "mrc_thread_kernel": ((8,),),
                 "compare_warp_kernel": ((5,),),
                 "compare_thread_kernel": ((8,),)}
TEMPLATE_ARG = re.compile(r"Li(\d+)E")


def kernel_of(symbol: str):
    """(kernel name, tuple of its integer template arguments or None) of a
    mangled symbol."""
    name = next((k for k in KERNEL_NAMES if k in symbol), None)
    args = tuple(int(v) for v in TEMPLATE_ARG.findall(symbol))
    return name, args or None


def sass_opcodes(library: str) -> dict:
    """Static SASS opcode counts of each kernel in the built library (the
    main path's instance of a templated one)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", library], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for block in sass.split("Function : ")[1:]:
        name, arg = kernel_of(block.splitlines()[0])
        if name is None or arg != MAIN_INSTANCE.get(name, (None,))[0]:
            continue
        ops = re.findall(SASS_OPCODE, block)
        out[name] = dict(Counter(ops).most_common())
    require(len(out) == len(KERNEL_NAMES), f"cuobjdump found kernels {sorted(out)}")
    return out


def ptxas_summary(ptxas: dict) -> dict:
    """The build's ptxas lines per source, for a templated kernel only those
    of the main paths' instances, with the registers and spill bytes of
    each such instance and the most registers and spill bytes over all."""
    out = {}
    for src, lines in ptxas.items():
        keep, regs, spills, show, inst, label = [], [], [], True, {}, None
        for ln in lines:
            if "Compiling entry function" in ln:
                name, arg = kernel_of(ln)
                show = arg is None or arg in MAIN_INSTANCE.get(name, ())
                label = (name if arg is None else
                         f"{name}<{', '.join(map(str, arg))}>")
            r = [int(v) for v in re.findall(r"Used (\d+) registers", ln)]
            b = [int(v) for v in re.findall(r"(\d+) bytes spill", ln)]
            regs += r
            spills += b
            if show:
                keep.append(ln)
                if r or b:
                    d = inst.setdefault(label, {"registers": None,
                                                "spill_bytes": 0})
                    d["registers"] = r[0] if r else d["registers"]
                    d["spill_bytes"] += sum(b)
        out[src] = {"lines": keep, "instances": inst,
                    "max_registers": max(regs, default=None),
                    "spill_bytes": sum(spills)}
    return out


def nest(flat: dict) -> dict:
    """{"a/b": v} -> {"a": {"b": v}}."""
    out = {}
    for name, v in flat.items():
        *path, leaf = name.split("/")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = v
    return out


def leaf_order() -> list:
    """The leaf names in the wire buffer's order (the reference's flatten
    order: sorted keys at every level), as ``model_tree`` holds them."""
    return list(model_tree())


def seeded_grad(shape, seed: int, dev):
    """N(0, 0.01**2) gradients from ``seed``, with every CLIP_STRIDE-th
    element scaled far past any codec's clip."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(shape, generator=gen, device=dev).mul_(1e-2)
    g.view(-1)[::CLIP_STRIDE].mul_(1e11)
    return g


def grad_seed(step: int, leaf: int) -> int:
    return 1000 * step + leaf


def quantized(codec, g):
    """The f64 oracle's integers: clip(round(g * 2**frac_bits), +-qmax)."""
    import torch

    r = torch.round(g.to(torch.float64) * (1 << codec.frac_bits))
    return torch.clamp(r, -codec.qmax, codec.qmax).to(torch.int64)


def oracle(codec, q, denom: float):
    """f32(q * 2**-frac_bits) / denom, the decode's value of integers q."""
    import torch

    return (q.to(torch.float64) * 2.0 ** -codec.frac_bits).to(
        torch.float32) / denom


def bits_equal(a, b) -> bool:
    """Bitwise equality of two tensors of one dtype and shape (-0.0 and
    NaN included)."""
    import torch

    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def launch_counts(ops) -> dict:
    return {"mrc": ops.mrc_op.launches, "modmul": ops.modmul_op.launches,
            "compare": ops.compare_op.launches,
            "codec_encode": ops.codec_encode_op.launches,
            "codec_decode": ops.codec_decode_op.launches,
            "mont_mul": ops.mont_mul_op.launches,
            "mont_ladder": ops.mont_ladder_op.launches}


def implied(**nonzero) -> dict:
    """Launch counts with every kernel not named at 0."""
    return {k: nonzero.get(k, 0) for k in ("mrc", "modmul", "compare",
                                           "codec_encode", "codec_decode",
                                           "mont_mul", "mont_ladder")}


def codec_tables(codec):
    """(encode tables, encode keywords, decode tables, decode keywords)."""
    from repro_torch.kernels import ops

    enc = ops._encode_tables(codec.base, codec.redundant)
    enc_kw = dict(scale=float(1 << codec.frac_bits), qh=codec.qmax >> 15,
                  ql=codec.qmax & 0x7FFF)
    dec = ops._decode_tables(codec.base)
    return enc, enc_kw, dec, dict(inv_scale=2.0 ** -codec.frac_bits)


def codec_parity(dev, max_err) -> int:
    """Each codec kernel against its plain version over the sweep, bit for
    bit; the wrappers and the f64 path agree with them too."""
    import torch

    from repro_torch.dist.grad_codec import GradCodec
    from repro_torch.kernels import ops
    from repro_torch.kernels.codec_decode import (codec_decode_kernel_call,
                                                  codec_decode_plain)
    from repro_torch.kernels.codec_encode import (codec_encode_kernel_call,
                                                  codec_encode_plain)

    gen = torch.Generator(device=dev).manual_seed(1)

    def hold_int(got, want, where):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err["codec_encode"] = max(max_err["codec_encode"], err)
        require(got.shape == want.shape and err == 0,
                f"codec_encode disagrees with its plain version at {where}")

    def hold_f32(got, want, where):
        err = float((got - want).abs().max())
        max_err["codec_decode"] = max(max_err["codec_decode"], err)
        require(bits_equal(got, want),
                f"codec_decode disagrees with its plain version at {where}")

    cases = 0
    for kw in CODEC_SWEEP:
        codec = GradCodec.make(**kw)
        enc, enc_kw, dec, dec_kw = codec_tables(codec)
        clip = torch.tensor(codec.clip, dtype=torch.float32)
        inf, nan = float("inf"), float("nan")
        up = torch.nextafter(clip, torch.tensor(inf))
        down = torch.nextafter(clip, torch.tensor(0.0))
        corners = torch.cat([
            torch.tensor([0.0, -0.0, inf, -inf, nan]), -torch.tensor([nan]),
            torch.stack([clip, -clip, up, -up, down, -down, 2 * clip,
                         -2 * clip]),
            torch.tensor([1e30, -1e30, 2.0 ** -17, -(2.0 ** -17),
                          3 * 2.0 ** -17, 1e-40])]).to(dev)
        extremes = (torch.stack([2 * clip, -2 * clip]).to(dev),
                    float(codec.qmax * codec.world) * 2.0 ** -codec.frac_bits)
        for batch in SWEEP_BATCHES:
            where = dict(kw, batch=batch)
            big = torch.rand(batch, generator=gen, device=dev) < 0.25
            scale = torch.where(big, 4 * codec.clip, 1e3)
            g = torch.randn(batch, generator=gen, device=dev) * scale
            k = min(batch, len(corners))
            g[:k] = corners[:k]
            want = codec_encode_plain(g, *enc, **enc_kw)
            hold_int(codec_encode_kernel_call(g, *enc, **enc_kw), want, where)
            hold_int(ops.codec_encode_op(codec, g), want.T, where)
            hold_int(codec.encode(g), want.T, where)           # f64 path
            # per-channel sums of up to 4 replicas, then +-qmax * world
            s = want.clone()
            for _ in range(min(codec.world, 4) - 1):
                s += codec_encode_plain(
                    torch.randn(batch, generator=gen, device=dev) * scale,
                    *enc, **enc_kw)
            ext = codec_encode_plain(extremes[0], *enc, **enc_kw) * codec.world
            s = torch.cat([s, ext], dim=1).contiguous()
            want_d = codec_decode_plain(s, *dec, **dec_kw)
            got_d = codec_decode_kernel_call(s, *dec, **dec_kw)
            hold_f32(got_d, want_d, where)
            hold_f32(ops.codec_decode_op(codec, s, channel_major=True),
                     want_d, where)
            hold_f32(codec.decode(codec.fold(s.T)), want_d, where)
            ext_want = torch.tensor([extremes[1], -extremes[1]],
                                    dtype=torch.float32, device=dev)
            require(bits_equal(got_d[-2:], ext_want),
                    f"codec_decode of +-qmax * world at {where}")
            cases += 1
    torch.cuda.synchronize()
    return cases


def codec_main_path(dev, group, max_err) -> dict:
    """Slice 2's main path: CODEC_STEPS AdamW steps on model_tree(), each
    composed as the reference's train step composes it, with the checks of
    each step after its launch counts are read."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.grad_codec import (GradCodec, tree_decode,
                                             tree_pack_rns)
    from repro_torch.kernels import ops
    from repro_torch.train import AdamWConfig, adamw_init, adamw_update

    codec = GradCodec.make(world=REPLICAS)   # examples/rns_gradient_training.py
    order = leaf_order()
    pgen = torch.Generator(device=dev).manual_seed(0)
    params = nest({name: torch.randn(model_tree()[name], generator=pgen,
                                     device=dev).mul_(0.02)
                   for name in order})
    opt = adamw_init(params)
    cfg = AdamWConfig()
    denom = float(dist.get_world_size(group))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    stages = ("gradients", "tree_pack_rns", "all_reduce", "adamw_update")
    for step in range(1, CODEC_STEPS + 1):
        before = launch_counts(ops)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        t0 = time.perf_counter()
        events[0].record()
        grads = nest({name: seeded_grad(model_tree()[name], grad_seed(step, i),
                                        dev)
                      for i, name in enumerate(order)})
        events[1].record()
        wire, meta = tree_pack_rns(codec, grads)
        del grads
        events[2].record()
        # the train step's one gradient collective: int32 SUM per channel
        dist.all_reduce(wire.residues, op=dist.ReduceOp.SUM, group=group)
        events[3].record()
        seen = {}

        def decode(summed):
            seen["grads"] = tree_decode(codec, summed, meta, denom=denom)
            return seen["grads"]

        params, opt, gnorm = adamw_update(cfg, params, wire, opt,
                                          grad_decode=decode)
        events[4].record()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        stages_ms = {name: events[i].elapsed_time(events[i + 1])
                     for i, name in enumerate(stages)}
        now = launch_counts(ops)
        got = {k: now[k] - before[k] for k in now}
        require(got == implied(codec_encode=1, codec_decode=1),
                f"codec step {step} launches {got}")
        require(bool(torch.isfinite(gnorm)), f"codec step {step}: gnorm")
        check_codec_step(codec, wire, seen.pop("grads"), order, step, denom,
                         dev, max_err)
        del wire
        emit({"phase": "codec", "step": step, "model": MODEL_NAME,
              "elements": wire_elements(), "seconds": seconds,
              "stages_ms": stages_ms, "launches": got, "gnorm": float(gnorm),
              "max_memory_allocated": torch.cuda.max_memory_allocated(dev)})
    launches = launch_counts(ops)
    for name, p in zip(order, _leaves(params)):
        require(bool(torch.isfinite(p).all()), f"codec: parameter {name}")
    require(int(opt["step"]) == CODEC_STEPS, "codec: optimizer step count")
    return {"launches": launches,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}


def wire_elements() -> int:
    import math

    return sum(math.prod(s) for s in model_tree().values())


def _leaves(tree):
    from repro_torch.dist._tree import flatten

    return flatten(tree)[0]


def _named(tree) -> list:
    from repro_torch.dist._tree import flatten_named

    return flatten_named(tree)


def check_codec_step(codec, wire, decoded, order, step, denom, dev,
                     max_err) -> None:
    """Over the whole buffer, in chunks: the wire (the one-rank all-reduce
    leaves it as encoded) equals the plain encode of the regenerated
    gradients, the decoded gradients equal the plain decode of the wire and
    the f64 oracle, bit for bit."""
    import torch

    from repro_torch.kernels.codec_decode import codec_decode_plain
    from repro_torch.kernels.codec_encode import codec_encode_plain

    enc, enc_kw, dec, dec_kw = codec_tables(codec)
    off = 0
    for i, (name, leaf) in enumerate(zip(order, _leaves(decoded))):
        g = seeded_grad(model_tree()[name], grad_seed(step, i), dev).view(-1)
        got = leaf.reshape(-1)
        for a in range(0, g.numel(), CHUNK):
            b = min(a + CHUNK, g.numel())
            cols = wire.residues[:, off + a : off + b]
            err = int((cols - codec_encode_plain(g[a:b], *enc, **enc_kw))
                      .abs().max())
            max_err["codec_encode"] = max(max_err["codec_encode"], err)
            require(err == 0, f"codec step {step}: the encode of {name} "
                    "differs from its plain version")
            want = codec_decode_plain(cols, *dec, **dec_kw) / denom
            max_err["codec_decode"] = max(max_err["codec_decode"],
                                          float((got[a:b] - want).abs().max()))
            require(bits_equal(got[a:b], want), f"codec step {step}: the "
                    f"decode of {name} differs from its plain version")
            require(bits_equal(got[a:b], oracle(codec, quantized(codec, g[a:b]),
                                                denom)),
                    f"codec step {step}: {name} differs from the f64 oracle")
        off += g.numel()
    require(off == wire.residues.shape[1], "codec: wire width")


def codec_replicas(dev) -> dict:
    """REPLICAS emulated replicas of one leaf: their summed encodings decode
    to the oracle sum / REPLICAS, and the sum's sign (one Alg.-1 compare
    launch after ``normalize``) matches the oracle's."""
    import torch

    from repro_torch.dist.grad_codec import GradCodec
    from repro_torch.kernels import ops

    codec = GradCodec.make(world=REPLICAS)
    shape = model_tree()[REPLICA_LEAF]
    ops.reset_launches()
    summed, v = None, None
    for r in range(REPLICAS):
        g = seeded_grad(shape, 50_000 + r, dev).view(-1)
        enc = codec.encode_packed(g, channel_major=True)
        summed = enc if summed is None else summed.add_(enc)
        q = quantized(codec, g)
        v = q if v is None else v.add_(q)
    arr = codec.as_array(summed, channel_major=True)
    got = codec.decode_summed(arr) / float(REPLICAS)
    require(bits_equal(got, oracle(codec, v, float(REPLICAS))),
            "codec replicas: the decoded sum differs from the f64 oracle")
    neg = codec.is_negative(codec.normalize(codec.fold(arr)))
    require(torch.equal(neg, v < 0), "codec replicas: the sign of the sum "
            "differs from the oracle's")
    torch.cuda.synchronize()
    launches = launch_counts(ops)
    require(launches == implied(codec_encode=REPLICAS, codec_decode=1,
                                compare=1),
            f"codec replicas launches {launches}")
    return {"leaf": REPLICA_LEAF, "elements": int(v.numel()),
            "replicas": REPLICAS, "launches": launches,
            "negative_share": float(neg.float().mean())}


def codec_rrns(dev) -> dict:
    """A locate-and-correct codec on one leaf: single-channel faults on every
    channel are located and repaired bitwise; a two-channel fault is
    refused (-2) and left as it was."""
    import torch

    from repro_torch.dist.fault import repair_packed
    from repro_torch.dist.grad_codec import GradCodec
    from repro_torch.kernels import ops

    codec = GradCodec.make(world=REPLICAS, correct=True)
    g = seeded_grad(model_tree()[REPLICA_LEAF], 60_000, dev).view(-1)
    ops.reset_launches()
    clean = codec.encode_array(g, channel_major=True).residues
    chans = tuple(codec.base.moduli) + codec.redundant
    B = clean.shape[1]
    bad, picks = clean.clone(), {}
    for c, mc in enumerate(chans):
        idx = torch.arange(4, device=dev) * (B // 4) + c * (B // 64) + 17
        bad[c, idx] = (bad[c, idx] + 1 + c) % mc
        picks[c] = idx
    fault = codec.locate_fault(codec.as_array(bad, channel_major=True))
    for c, idx in picks.items():
        require(bool((fault[idx] == c).all()),
                f"codec rrns: a fault on channel {c} was not located")
    n_faults = 4 * len(chans)
    require(int((fault >= 0).sum()) == n_faults and not (fault == -2).any(),
            "codec rrns: locate reports other elements")
    fixed, report = repair_packed(codec, codec.as_array(bad,
                                                        channel_major=True))
    require(report == {"repaired": n_faults, "unrecoverable": 0},
            f"codec rrns: repair report {report}")
    require(torch.equal(fixed.residues, clean),
            "codec rrns: the repaired buffer differs from the clean one")
    two, e = clean.clone(), B // 3
    two[0, e] = (two[0, e] + 1) % chans[0]
    two[3, e] = (two[3, e] + 2) % chans[3]
    kept, refused = repair_packed(codec, codec.as_array(two,
                                                        channel_major=True))
    require(refused == {"repaired": 0, "unrecoverable": 1},
            f"codec rrns: two-channel fault report {refused}")
    require(torch.equal(kept.residues, two),
            "codec rrns: a refused element was changed")
    require(int(codec.locate_fault(codec.as_array(two, channel_major=True))[e])
            == -2, "codec rrns: a two-channel fault was not refused")
    torch.cuda.synchronize()
    launches = launch_counts(ops)
    require(launches == implied(codec_encode=1),
            f"codec rrns launches {launches}")
    return {"leaf": REPLICA_LEAF, "channels": len(chans), "faults": n_faults,
            "report": report, "two_channel_report": refused,
            "launches": launches}


# ---------------------------------------------- slice 4: the training path
def check_train_encode(codec, grads, wire, max_err) -> int:
    """A training step's wire buffer (the codec_encode kernel's output on
    the step's real gradients) against the plain encode of those gradients,
    leaf by leaf in CHUNK-element pieces, bit for bit.  Returns the elements
    compared."""
    from repro_torch.kernels.codec_encode import codec_encode_plain

    enc, enc_kw, _, _ = codec_tables(codec)
    off = 0
    for leaf in _leaves(grads):
        g = leaf.reshape(-1)
        for a in range(0, g.numel(), CHUNK):
            b = min(a + CHUNK, g.numel())
            err = int((wire.residues[:, off + a : off + b]
                       - codec_encode_plain(g[a:b], *enc, **enc_kw))
                      .abs().max())
            max_err["codec_encode"] = max(max_err["codec_encode"], err)
            require(err == 0, "train: the encode of the real gradients "
                    "differs from its plain version")
        off += g.numel()
    require(off == wire.residues.shape[1], "train: wire width")
    return off


def check_train_decode(codec, summed, decoded, denom, max_err) -> int:
    """The decoded gradient tree (the codec_decode kernel's output at the
    optimizer boundary) against the plain decode of the summed wire / the
    group's size, in CHUNK-element pieces, bit for bit.  Returns the
    elements compared."""
    from repro_torch.kernels.codec_decode import codec_decode_plain

    _, _, dec, dec_kw = codec_tables(codec)
    off = 0
    for leaf in _leaves(decoded):
        got = leaf.reshape(-1)
        for a in range(0, got.numel(), CHUNK):
            b = min(a + CHUNK, got.numel())
            want = codec_decode_plain(summed.residues[:, off + a : off + b],
                                      *dec, **dec_kw) / denom
            max_err["codec_decode"] = max(max_err["codec_decode"],
                                          float((got[a:b] - want).abs().max()))
            require(bits_equal(got[a:b], want), "train: the decode of the "
                    "summed wire differs from its plain version")
        off += got.numel()
    require(off == summed.residues.shape[1], "train: decoded width")
    return off


class TrainProbe:
    """Instrumentation of ``repro_torch.train.train_step`` around one run of
    the training driver.  It wraps the functions a step calls: CUDA events
    around each stage (forward_backward, tree_pack_rns, all_reduce — the
    ``psum`` of the 2-D wire buffer; the other ``psum`` calls carry the
    metrics — and adamw_update with its decode), the
    launch counters read at a step's first call and after its optimizer
    update, and on step ``check`` the encode and the decode held against
    their plain versions over the whole buffer (after the encode's closing
    event, inside the update's: that step's ``adamw_update`` time holds the
    decode's check)."""

    NAMES = ("value_and_grad", "tree_pack_rns", "psum", "adamw_update",
             "tree_decode")

    def __init__(self, max_err, check=None):
        from repro_torch.kernels import ops
        from repro_torch.train import train_step

        self.ts, self.ops, self.max_err, self.check = (train_step, ops,
                                                       max_err, check)
        self.steps, self.checked = [], {}

    def __enter__(self):
        self.orig = {name: getattr(self.ts, name) for name in self.NAMES}
        for name in self.NAMES:
            setattr(self.ts, name, getattr(self, "_" + name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ts, name, fn)

    def _stage(self, stage, fn, *args, **kw):
        import torch

        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*args, **kw)
        e1.record()
        self.steps[-1]["events"][stage] = (e0, e1)
        return out

    def _checking(self) -> bool:
        return len(self.steps) - 1 == self.check

    def _value_and_grad(self, loss_fn, params, batch):
        self.steps.append({"events": {}, "before": launch_counts(self.ops)})
        return self._stage("forward_backward", self.orig["value_and_grad"],
                           loss_fn, params, batch)

    def _tree_pack_rns(self, codec, grads):
        wire, meta = self._stage("tree_pack_rns", self.orig["tree_pack_rns"],
                                 codec, grads)
        if self._checking():
            self.checked["codec_encode"] = check_train_encode(
                codec, grads, wire, self.max_err)
        return wire, meta

    def _psum(self, t, group):
        if t.dim() != 2:
            return self.orig["psum"](t, group)
        return self._stage("all_reduce", self.orig["psum"], t, group)

    def _adamw_update(self, *args, **kw):
        out = self._stage("adamw_update", self.orig["adamw_update"], *args,
                          **kw)
        self.steps[-1]["after"] = launch_counts(self.ops)
        return out

    def _tree_decode(self, codec, summed, meta, denom=1.0):
        out = self.orig["tree_decode"](codec, summed, meta, denom=denom)
        if self._checking():
            self.checked["codec_decode"] = check_train_decode(
                codec, summed, out, denom, self.max_err)
        return out

    def report(self) -> list:
        """Per step: stage ms from the events, and launches."""
        import torch

        torch.cuda.synchronize()
        return [{"stages_ms": {k: a.elapsed_time(b)
                               for k, (a, b) in s["events"].items()},
                 "launches": {k: s["after"][k] - s["before"][k]
                              for k in s["after"]}}
                for s in self.steps]


def train_reckoning(elements: int, channels: int) -> dict:
    """The bytes of the training state on one rank, before activations:
    ``elements`` f32 parameters, AdamW's m and v, the gradients, the flat
    buffer ``tree_pack`` encodes, the int32 wire of ``channels`` channels
    and the decoded flat buffer (``channels`` = 0: the fp32 path, no codec
    buffers)."""
    f32 = 4 * elements
    out = {"params": f32, "adamw_m_v": 2 * f32, "grads": f32}
    if channels:
        out.update(flat=f32, wire=channels * f32, decoded=f32)
    out["total"] = sum(out.values())
    return out


@contextlib.contextmanager
def replaced_config(module, **fields):
    """``module.get_config`` (a launcher's) returning its configs with
    ``fields`` replaced, for the length of the block (none: unchanged)."""
    orig = module.get_config
    if fields:
        module.get_config = lambda name: dataclasses.replace(orig(name),
                                                             **fields)
    try:
        yield
    finally:
        module.get_config = orig


def cut_depth(module, layers):
    """``replaced_config`` cutting the configs to ``layers`` layers (None:
    unchanged)."""
    return replaced_config(module, **({} if layers is None
                                      else {"n_layers": layers}))


def train_run(dev, max_err, label, flags=(), check=None, args=TRAIN_ARGS,
              layers=None, phase="train") -> dict:
    """One run of ``repro_torch.launch.train.main`` on ``args`` and
    ``flags`` (the model cut to ``layers`` layers when given) under a
    TrainProbe, its own output captured; each step's line emitted.
    Returns the run's summary with ``params``, per-step stages and
    launches, and the launches summed."""
    import io

    import torch

    from repro_torch.launch import train as launch_train

    free_card()
    argv = [*args, "--device", DEVICE, *flags]
    out = io.StringIO()
    with TrainProbe(max_err, check) as probe, \
            contextlib.redirect_stdout(out), cut_depth(launch_train, layers):
        t0 = time.perf_counter()
        params, summary = launch_train.main(argv)
        seconds = time.perf_counter() - t0
    steps = probe.report()
    channels = (5 if "--rns-correct" in flags
                else 4 if "--rns-allreduce" in flags else 0)
    want = implied(codec_encode=1, codec_decode=1) if channels else implied()
    total = Counter()
    for i, s in enumerate(steps):
        require(s["launches"] == want,
                f"train {label} step {i} launches {s['launches']}")
        require(math.isfinite(summary["losses"][i]),
                f"train {label} step {i}: loss {summary['losses'][i]}")
        total.update(s["launches"])
        row = {"phase": phase, "run": label,
               "step": summary["start_step"] + i,
               "loss": summary["losses"][i], "aux": summary["auxes"][i],
               "gnorm": summary["gnorms"][i],
               "ms": summary["step_ms"][i],
               "tokens_per_s": summary["tokens_per_s"][i],
               "stages_ms": s["stages_ms"], "launches": s["launches"],
               "checked": i == check}
        for k in ("repaired", "unrepairable"):
            if k in summary:
                row[k] = summary[k][i]
        emit(row)
    for name, p in _named(params):
        require(bool(torch.isfinite(p).all()), f"train {label}: {name}")
    require(out.getvalue().strip().splitlines()[-1] == json.dumps(summary),
            f"train {label}: the training CLI's summary line")
    elements = sum(p.numel() for _, p in _named(params))
    if check is not None:
        require(probe.checked == {"codec_encode": elements,
                                  "codec_decode": elements},
                f"train {label}: kernels checked {probe.checked}")
    return {"params": params, "summary": summary, "seconds": seconds,
            "launches": implied(**total), "checked": probe.checked,
            "elements": elements, "printed": out.getvalue(),
            "reckoned_bytes": train_reckoning(elements, channels)}


def train_main_path(dev, max_err) -> dict:
    """The training path at full width (TRAIN_ARGS): the fp32 run, the RNS
    run (its step TRAIN_CHECK_STEP held kernel by kernel against the plain
    versions), their per-step loss drift; the RRNS run with a wire residue
    corrupted at TRAIN_INJECT_STEP against the same run without one, bit
    for bit; then the rns_gradient_training example at smoke size."""
    import torch

    from repro_torch import rns_gradient_training
    from repro_torch.kernels import ops

    runs, launches = {}, Counter()

    def run(label, flags=(), check=None, keep=False):
        r = train_run(dev, max_err, label, flags, check)
        launches.update(r["launches"])
        s = r["summary"]
        emit({"phase": "train", "run": label, "seconds": r["seconds"],
              "elements": r["elements"], "losses": s["losses"],
              "step_ms_median": statistics.median(s["step_ms"]),
              "tokens_per_s_median": statistics.median(s["tokens_per_s"]),
              "max_memory_allocated": s["max_memory_allocated"],
              "reckoned_bytes": r["reckoned_bytes"],
              "launches": r["launches"], "checked": r["checked"]})
        runs[label] = s
        return r["params"] if keep else None

    run("fp32")
    run("rns", ("--rns-allreduce",), check=TRAIN_CHECK_STEP)
    drift = max(abs(a - b) for a, b in zip(runs["rns"]["losses"],
                                           runs["fp32"]["losses"]))
    require(drift < TRAIN_MAX_DRIFT, f"train: RNS loss drift {drift}")
    hit = run("rns_correct_injected",
              ("--rns-correct", "--inject-corrupt-step",
               str(TRAIN_INJECT_STEP)), keep=True)
    clean = run("rns_correct", ("--rns-correct",), keep=True)
    steps = len(runs["rns_correct"]["losses"])
    require(runs["rns_correct_injected"]["repaired"]
            == [int(i == TRAIN_INJECT_STEP) for i in range(steps)]
            and runs["rns_correct"]["repaired"] == [0] * steps,
            "train: repaired counts")
    require(runs["rns_correct_injected"]["unrepairable"]
            == runs["rns_correct"]["unrepairable"] == [0] * steps,
            "train: unrepairable counts")
    for (name, a), (_, b) in zip(_named(hit), _named(clean)):
        require(bits_equal(a, b), f"train: {name} after the repaired run "
                "differs from the run without the fault")
    del hit, clean

    # the example at smoke size, on the card
    torch.cuda.empty_cache()
    ops.reset_launches()
    t0 = time.perf_counter()
    ex = rns_gradient_training.main(dev, verbose=False)
    example_s = time.perf_counter() - t0
    got = launch_counts(ops)
    n = rns_gradient_training.STEPS
    require(got == implied(codec_encode=n, codec_decode=n),
            f"rns_gradient_training launches {got}")
    emit({"phase": "train", "run": "rns_gradient_training",
          "seconds": example_s, "drift": ex["drift"],
          "first_loss": ex["l_rns"][0], "last_loss": ex["l_rns"][-1],
          "launches": got})
    return {"launches": implied(**launches), "drift": drift,
            "example_drift": ex["drift"],
            "fp32_step_ms_median": statistics.median(
                runs["fp32"]["step_ms"])}


def e2e_path(dev) -> dict:
    """The train_e2e example on the card: its 300 steps, a checkpoint
    every 100 (three, in the legacy format, under E2E_DIR), a final loss
    under 3.0, and none of the seven kernels launched (the fp32 path)."""
    import torch

    from repro_torch import train_e2e
    from repro_torch.kernels import ops

    free_card()
    shutil.rmtree(E2E_DIR, ignore_errors=True)
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        r = train_e2e.main(dev, ckpt_dir=E2E_DIR, verbose=False)
        seconds = time.perf_counter() - t0
        launches = launch_counts(ops)
        names = sorted(os.listdir(E2E_DIR))
    finally:
        shutil.rmtree(E2E_DIR, ignore_errors=True)
    steps = train_e2e.STEPS
    require(len(r["losses"]) == steps
            and r["losses"][-1] < train_e2e.MAX_FINAL_LOSS,
            f"train_e2e: final loss {r['losses'][-1]}")
    require(names == [f"step_{s}" for s in (100, 200, 300)]
            and len(r["checkpoints"]) == 3,
            f"train_e2e: checkpoints {names}")
    require(launches == implied(), f"train_e2e launches {launches}")
    del r["params"], r["opt"]
    torch.cuda.synchronize()
    return {"seconds": seconds, "steps": steps, "n_params": r["n_params"],
            "ms_per_step": r["ms_per_step"], "first_loss": r["losses"][0],
            "final_loss": r["losses"][-1], "checkpoints": names,
            "launches": launches}


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def host_rss_peak() -> int:
    """The process's peak resident set so far, in bytes."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def ckpt_tree() -> dict:
    """{leaf name: shape} of gemma3-1b's parameters cut to CKPT_LAYERS."""
    from repro_torch.configs import get_config
    from repro_torch.dist._tree import flatten_named
    from repro_torch.models import abstract_params

    cfg = get_config("gemma3-1b")
    if CKPT_LAYERS is not None:
        cfg = dataclasses.replace(cfg, n_layers=CKPT_LAYERS)
    return {name: tuple(leaf.shape) for name, leaf in
            flatten_named(abstract_params(cfg))}


def ckpt_main_path(dev, max_err, fp32_step_ms) -> dict:
    """Phase 5e: gemma3-1b's training state, at full width cut to
    CKPT_LAYERS, through the RRNS checkpointer.  Run U trains TRAIN_ARGS'
    fp32 steps uninterrupted; run S trains CKPT_SAVE_STEPS with one async
    rrns-v1 save after step CKPT_SAVED_STEP, written while the next step
    runs; run R corrupts one RRNS channel of leaf 0 of that save
    (``--inject-ckpt-corrupt 1``), restores it with the channel repaired
    and trains the remaining steps: its final parameters must equal run
    U's leaf by leaf (``tensor_fingerprint``).  Reports the snapshot's ms
    on the training thread, the writer's encode, write + fsync and sha
    seconds, the bytes on disk and the rates, each step's ms beside run
    U's and 5b's median, the restore's read, decode, sha and repair
    seconds, and the peaks of host RSS and device memory."""
    from repro_torch.dist.fault import tensor_fingerprint
    from repro_torch.train import checkpointer as ckpt

    tree = ckpt_tree()
    elements = sum(math.prod(s) for s in tree.values())
    limbs = 3 * elements + 1                  # params, m, v and the step
    leaves = 3 * len(tree) + 1
    payload = CKPT_CHANNELS * 4 * limbs       # the wire files' int32 data
    need = payload + leaves * 256 + (1 << 20)  # headers, the manifest
    require(need < RUN_WRITE_LIMIT * 3 // 4,
            f"ckpt: {need} bytes to write, the run may write "
            f"{RUN_WRITE_LIMIT} in all")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    free = shutil.disk_usage(CKPT_DIR).free
    require(free > need, f"ckpt: the save needs {need} bytes on disk under "
            f"{CKPT_DIR}, {free} are free")
    rss_before = host_rss_peak()
    t_start = time.perf_counter()
    whole = train_run(dev, max_err, "uninterrupted", args=TRAIN_ARGS,
                      layers=CKPT_LAYERS, phase="ckpt")
    want = {name: tensor_fingerprint(p) for name, p in _named(whole["params"])}
    del whole["params"]
    try:
        save = train_run(dev, max_err, "save",
                         ("--ckpt-dir", CKPT_DIR) + CKPT_SAVE_FLAGS,
                         args=with_flag(TRAIN_ARGS, "--steps",
                                        str(CKPT_SAVE_STEPS)),
                         layers=CKPT_LAYERS, phase="ckpt")
        rss_save = host_rss_peak()
        s = save["summary"]
        saves = s["ckpt_saves"]
        require(len(saves) == 1 and saves[0]["step"] == CKPT_SAVED_STEP
                and ckpt.discover_steps(CKPT_DIR) == [CKPT_SAVED_STEP],
                f"ckpt: saves {saves}, on disk "
                f"{ckpt.discover_steps(CKPT_DIR)}")
        step_dir = os.path.join(CKPT_DIR, f"step_{CKPT_SAVED_STEP}")
        on_disk = dir_bytes(step_dir)
        require(payload < saves[0]["bytes"] < on_disk < need,
                f"ckpt: {saves[0]['bytes']} wire bytes, {on_disk} on disk, "
                f"{payload} of residues reckoned")
        del save["params"]
        resume = train_run(dev, max_err, "resume",
                           ("--ckpt-dir", CKPT_DIR, "--inject-ckpt-corrupt",
                            "1"), args=TRAIN_ARGS, layers=CKPT_LAYERS,
                           phase="ckpt")
        rss_resume = host_rss_peak()
        on_mesh = mesh_restore(dev, os.path.join(CKPT_DIR,
                                                 f"step_{CKPT_SAVED_STEP}"))
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    printed, r = resume["printed"], resume["summary"]
    require(f"[inject] corrupted 1 RRNS channel(s) of step "
            f"{CKPT_SAVED_STEP}, leaf 0, element 0" in printed,
            "ckpt: the [inject] line")
    line = next((ln for ln in printed.splitlines()
                 if ln.startswith("[resume] restored step")), "")
    require(line.startswith(f"[resume] restored step {CKPT_SAVED_STEP}: ")
            and "repaired_leaves=1 " in line and "steps_skipped=0" in line,
            f"ckpt: resume line {line!r}")
    steps = int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1])
    require(r["start_step"] == CKPT_SAVED_STEP
            and len(r["losses"]) == steps - CKPT_SAVED_STEP,
            f"ckpt: resumed at {r['start_step']}, {len(r['losses'])} steps")
    got = {name: tensor_fingerprint(p) for name, p in _named(resume["params"])}
    differ = sorted(n for n in got if got[n] != want.get(n))
    require(got.keys() == want.keys() and not differ,
            f"ckpt: resumed parameters differ from run U's: {differ}")
    del resume["params"]
    w, rest = saves[0], r["restored"]
    wire_gb = w["bytes"] / 1e9
    return {
        "seconds": time.perf_counter() - t_start,
        "layers": CKPT_LAYERS, "elements": elements,
        "wire_bytes": w["bytes"],
        "on_disk_bytes": on_disk, "disk_free_before": free,
        "snapshot_ms": w["snapshot_ms"], "writer_seconds": w["seconds"],
        "encode_s": w["encode_s"], "write_fsync_s": w["write_s"],
        "sha_s": w["sha_s"],
        "write_fsync_gb_per_s": wire_gb / w["write_s"],
        "writer_gb_per_s": wire_gb / w["seconds"],
        "save_step_ms": s["step_ms"],
        "in_flight_step": CKPT_SAVED_STEP,
        "in_flight_step_ms": s["step_ms"][CKPT_SAVED_STEP],
        "uninterrupted_step_ms": whole["summary"]["step_ms"],
        "fp32_step_ms_median": fp32_step_ms,
        "save_run_seconds": save["seconds"],
        "restore": rest,
        "restore_base_gb_per_s": 0.6 * wire_gb / rest["read_s"],
        "resume_step_ms": r["step_ms"],
        "resume_run_seconds": resume["seconds"],
        "repaired_leaves": rest["repaired_leaves"],
        "repaired_elements": rest["repaired_elements"],
        "params_equal_uninterrupted": True,
        "mesh_restore": on_mesh,
        "max_memory_allocated": {
            "uninterrupted": whole["summary"]["max_memory_allocated"],
            "save": s["max_memory_allocated"],
            "resume": r["max_memory_allocated"]},
        "host_rss_peak": {"before": rss_before, "save": rss_save,
                          "resume": rss_resume},
        "launches": implied(**(Counter(whole["launches"])
                               + Counter(save["launches"])
                               + Counter(resume["launches"]))),
    }


# --------------------------------------------------- slice 10: the mesh
def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mesh_restore(dev, step_dir: str) -> dict:
    """Phase 5f (c), inside 5e: its rrns-v1 step restored twice — onto one
    device (``device=``) and onto a (1, 1) mesh (``shardings=``: the
    parameter specs, the ZeRO-1 specs for the moments, the step
    replicated) — leaf by leaf bit-equal, with the seconds of each."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import abstract_params
    from repro_torch.train import adamw_init
    from repro_torch.train import checkpointer as ckpt

    cfg = dataclasses.replace(get_config(MESH_ARCH), n_layers=CKPT_LAYERS)
    pa = abstract_params(cfg)
    tree = {"params": pa, "opt": adamw_init(pa)}
    mesh = make_host_mesh(dev.type)
    try:
        ps = sh.param_specs(pa, mesh)
        zs = sh.opt_state_specs(pa, ps, mesh, zero1=cfg.zero1)
        shard = {"params": sh.named_shardings(ps, mesh),
                 "opt": {"m": sh.named_shardings(zs, mesh),
                         "v": sh.named_shardings(zs, mesh),
                         "step": sh.named_shardings(sh.PartitionSpec(),
                                                    mesh)}}
        base = os.path.dirname(step_dir)
        step = int(os.path.basename(step_dir).split("_")[1])
        times = {}
        sync(dev)
        t0 = time.perf_counter()
        plain, _, _, rep = ckpt.restore(base, tree, step=step, device=dev)
        sync(dev)
        times["device_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        placed, _, _, rep_m = ckpt.restore(base, tree, shard, step=step)
        sync(dev)
        times["shardings_s"] = time.perf_counter() - t0
        leaves = 0
        for (name, a), b, s in zip(_named(plain), _leaves(placed),
                                   _leaves(shard)):
            require(tuple(b.placements) == tuple(s.placements)
                    and bits_equal(a, b.to_local()),
                    f"mesh restore: {name} differs from the device= restore")
            leaves += 1
        require(rep_m["repaired_leaves"] == rep["repaired_leaves"],
                f"mesh restore: repair reports {rep_m} / {rep}")
        del plain, placed
    finally:
        dist.destroy_process_group()
    free_card()
    return {"leaves": leaves, "repaired_leaves": rep_m["repaired_leaves"],
            "bit_equal": True, **times}


def mesh_train(dev, mesh, max_err) -> dict:
    """Phase 5f (a): MESH_FP32_STEPS fp32 then MESH_CODEC_STEPS codec steps
    of gemma3-1b at full width and depth on ``mesh`` and with no mesh, in
    lockstep from the same seed: after every step the parameters, moments
    and loss are bit-equal.  The first codec step on the mesh records the
    gradients it encodes, its wire, the summed wire and the decode, which
    are held against the plain versions (a one-rank group's sum leaves
    the wire as it was encoded)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.dist import _tree
    from repro_torch.dist import sharding as sh
    from repro_torch.dist.grad_codec import GradCodec
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, adamw_init
    from repro_torch.train import train_step as TS

    cfg = get_config(MESH_ARCH)
    params = init_params(cfg, 0, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    batches = [{"tokens": torch.randint(0, cfg.vocab,
                                        (MESH_BATCH, MESH_SEQ + 1),
                                        generator=gen, device=dev,
                                        dtype=torch.int32)}
               for _ in range(MESH_FP32_STEPS + MESH_CODEC_STEPS)]
    ps = sh.param_specs(params, mesh)
    zs = sh.opt_state_specs(params, ps, mesh, zero1=cfg.zero1)
    grad_sh = sh.named_shardings(ps, mesh)
    place = lambda tree, specs: _tree.tree_map(
        sh.place_host, tree, sh.named_shardings(specs, mesh))
    st = adamw_init(params)
    state = {"plain": (params, st),
             "mesh": (place(params, ps),
                      {"m": place(st["m"], zs), "v": place(st["v"], zs),
                       "step": st["step"]})}
    codec = GradCodec.make(world=1)
    opt_cfg = AdamWConfig()
    fns = {
        ("plain", False): TS.make_train_step(cfg, opt_cfg),
        ("mesh", False): TS.make_train_step(cfg, opt_cfg, mesh=mesh,
                                            grad_shardings=grad_sh),
        ("plain", True): TS.make_train_step(cfg, opt_cfg, rns_codec=codec,
                                            group=dist.group.WORLD),
        ("mesh", True): TS.make_train_step(cfg, opt_cfg, mesh=mesh,
                                           grad_shardings=grad_sh,
                                           rns_codec=codec),
    }
    pack, decode = TS.tree_pack_rns, TS.tree_decode
    row = {}

    # the checks run inside the step, as the buffers appear: holding them
    # to its end would add 8 GB to a step that peaks near the card's size
    def pack_probe(c, grads):
        wire, meta = pack(c, grads)
        row["encode_checked"] = check_train_encode(c, grads, wire, max_err)
        return wire, meta

    def decode_probe(c, summed, meta, denom=1.0):
        out = decode(c, summed, meta, denom=denom)
        row["decode_checked"] = check_train_decode(c, summed, out, denom,
                                                   max_err)
        return out

    rows = []
    for i, batch in enumerate(batches):
        codec_step = i >= MESH_FP32_STEPS
        if i == MESH_FP32_STEPS:
            free_card()
        row = {"step": i, "codec": codec_step}   # the probes write here
        for side in ("plain", "mesh"):
            b = (batch if side == "plain" else
                 place(batch, sh.batch_specs(batch, mesh)))
            probe = side == "mesh" and i == MESH_FP32_STEPS
            if probe:
                TS.tree_pack_rns, TS.tree_decode = pack_probe, decode_probe
            try:
                sync(dev)
                before, t0 = launch_counts(ops), time.perf_counter()
                p, o, m = fns[(side, codec_step)](*state[side], b)
                sync(dev)
                row[f"{side}_ms"] = (time.perf_counter() - t0) * 1e3
            finally:
                TS.tree_pack_rns, TS.tree_decode = pack, decode
            after = launch_counts(ops)
            row[f"{side}_launches"] = {k: after[k] - before[k]
                                       for k in ("codec_encode",
                                                 "codec_decode")}
            row[f"{side}_loss"] = float(m["loss"])
            state[side] = (p, o)
        want = {"codec_encode": int(codec_step),
                "codec_decode": int(codec_step)}
        require(row["plain_launches"] == want == row["mesh_launches"],
                f"mesh train: step {i} launches {row}")
        require(row["plain_loss"] == row["mesh_loss"],
                f"mesh train: step {i} loss {row}")
        for (name, a), b in zip(_named(state["plain"]),
                                _leaves(state["mesh"])):
            require(bits_equal(a, b.to_local() if hasattr(b, "to_local")
                              else b),
                    f"mesh train: step {i}, {name} differs from no mesh")
        rows.append(row)
        emit({"phase": "mesh", "step": "train", **row})
    placements = str(state["mesh"][1]["m"]["embed"].placements)
    del state, fns, params
    free_card()
    return {"steps": rows, "zero1_m_placements": placements,
            "bit_equal": True}


def mesh_serve(dev, mesh) -> dict:
    """Phase 5f (b): the paged engine on WARM_SHARED requests behind the
    1,024-token prefix, WARM_MAX_NEW new tokens, with and without
    ``mesh=``: tokens, verify log and the whole pool bit-equal, each
    decode step timed (CUDA-synchronized host ms)."""
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve.batcher import ContinuousBatcher
    from repro_torch.serve.scheduler import Request

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    path = os.path.join(ROOT, "chiprun_out", "mesh_trace.jsonl")
    reqs = paged_trace(path, PAGED_ENGINE, shared=WARM_SHARED, bare=0,
                       max_new=WARM_MAX_NEW)
    cfg = get_config(MESH_ARCH)
    params = init_params(cfg, 0, dev)
    out = {}
    for side, m in (("plain", None), ("mesh", mesh)):
        eng = ContinuousBatcher(cfg, params, n_slots=8, cache_len=2048,
                                prefill_chunk=256, page_size=512,
                                rns_verify=True, mesh=m)
        step, times = eng._decode_fn, []

        def timed(*args, step=step, times=times):
            sync(dev)
            t0 = time.perf_counter()
            res = step(*args)
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            return res

        eng._decode_fn = timed
        for r in reqs:
            eng.submit(Request(rid=r["rid"], prompt=r["prompt"],
                               max_new=r["max_new"]))
        t0 = time.perf_counter()
        done = eng.run_to_completion()
        out[side] = {
            "seconds": time.perf_counter() - t0,
            "tokens": sorted((r.rid, list(r.out)) for r in done),
            "verify_log": dict(eng.verify_log),
            "pool": {k: (v.full_tensor() if hasattr(v, "full_tensor")
                         else v) for k, v in eng.cache.items()
                     if isinstance(v, torch.Tensor)},
            "decode_ms_median": statistics.median(times),
            "decode_steps": len(times),
        }
        del eng
    a, b = out["plain"], out["mesh"]
    require(a["tokens"] == b["tokens"] and len(a["tokens"]) == WARM_SHARED,
            "mesh serve: tokens differ from the engine without a mesh")
    require(a["verify_log"] == b["verify_log"]
            and all(a["verify_log"].values()),
            f"mesh serve: verify logs {a['verify_log']} / {b['verify_log']}")
    for k in a["pool"]:
        require(bits_equal(a["pool"][k], b["pool"][k]),
                f"mesh serve: pool leaf {k} differs")
    res = {"requests": len(reqs), "tokens_equal": True, "pool_equal": True,
           **{f"{s}_{k}": out[s][k] for s in out
              for k in ("seconds", "decode_ms_median", "decode_steps")}}
    del out, params
    free_card()
    return res


def mesh_dryrun() -> dict:
    """Phase 5f (d) and 5g (d): ``launch.dryrun`` of gemma3-1b's train_4k
    and prefill_32k cells on the (16, 16) production mesh over a fake
    group, in a process of their own (the fake group must be its only
    one); each record's memory, roofline and collectives.  The prefill
    cell must fit the card."""
    out_dir = os.path.join(ROOT, "chiprun_out", "dryrun")
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cells = (MESH_DRYRUN, FLASH_DRYRUN)
    script = ("import sys; from repro_torch.launch import dryrun; "
              + "; ".join(f"dryrun.main({[*c, '--out', out_dir]!r})"
                          for c in cells))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    require(proc.returncode == 0,
            f"mesh dry run failed: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    out = {"seconds": time.perf_counter() - t0}
    for c in cells:
        arch, shape = c[c.index("--arch") + 1], c[c.index("--shape") + 1]
        with open(os.path.join(out_dir, f"{arch}__{shape}__single.json")) as f:
            rec = json.load(f)
        out[shape] = {"devices": rec["devices"], "memory": rec["memory"],
                      "roofline": rec["roofline"],
                      "collectives": rec["collectives"],
                      "useful_flops_ratio": rec["useful_flops_ratio"],
                      "local_ops": rec["local_ops"], "run_s": rec["run_s"]}
    mem = out["prefill_32k"]["memory"]
    require(mem["fits_hbm"] and mem["per_device_bytes"] < 80e9,
            f"dry run: prefill_32k takes {mem['per_device_bytes']} bytes a "
            "device")
    return out


def mesh_main_path(dev, max_err) -> dict:
    """Phase 5f (a), (b) and (d) on one (1, 1) mesh over a one-rank NCCL
    group, made and torn down here."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh

    t_start = time.perf_counter()
    before = launch_counts(ops)
    mesh = make_host_mesh(dev.type)
    try:
        # NCCL makes a communicator's buffers at its first collective:
        # make both now, before the training state fills the card
        one = torch.zeros(1, device=dev)
        dist.all_reduce(one)
        dist.all_reduce(one, group=mesh.get_group("data"))
        train = mesh_train(dev, mesh, max_err)
        serve = mesh_serve(dev, mesh)
    finally:
        dist.destroy_process_group()
    after = launch_counts(ops)
    dry = mesh_dryrun()
    return {"seconds": time.perf_counter() - t_start, "train": train,
            "serve": serve, "dryrun": dry,
            "launches": {k: after[k] - before[k] for k in after}}


# -------------------------------- slice 11: the chunked attention routes
def cuda_timed(fn):
    """(fn(), its ms between two CUDA events)."""
    import torch

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def launching_ops(fn):
    """(fn(), the aten ops it dispatches that are not views): each launches
    a kernel on the card, a matmul sometimes two, so it counts the
    launches from below."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += not func.is_view
            return func(*args, **(kwargs or {}))

    with Count() as count:
        out = fn()
    return out, count.n


@contextlib.contextmanager
def whole_row_attention():
    """The models' attention routed to the plain whole-row ``attention``
    for the length of the block."""
    from repro_torch.models import attention as attn

    orig = attn.flash_attention
    attn.flash_attention = lambda q, k, v, *, causal=True, window=None, \
        **_: attn.attention(q, k, v, causal=causal, window=window)
    try:
        yield
    finally:
        attn.flash_attention = orig


def peak_above(fn):
    """(fn(), the card's peak allocated bytes during it above what was
    allocated when it started)."""
    import torch

    free_card()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def flash_prefill_path(dev) -> dict:
    """Phase 5g (a) and (b): the FLASH_PROMPT-token prefill and its
    decode steps against a teacher-forced forward, then the FLASH_AGREE
    agreement of the chunked route with the whole-row one."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, init_params, prefill,
                                    train_logits)
    from repro_torch.models.transformer import global_flags

    cfg = get_config(FLASH_ARCH)
    require([i + 1 for i in np.flatnonzero(global_flags(cfg))]
            == [6, 12, 18, 24] and cfg.n_layers == 26,
            f"flash: {cfg.name}'s global layers")
    params = init_params(cfg, 0, dev)
    prompt = np.random.default_rng(0).integers(1, cfg.vocab,
                                               FLASH_PROMPT).tolist()
    tokens = torch.tensor([prompt], dtype=torch.int32, device=dev)
    out = {"layers": cfg.n_layers, "prompt": FLASH_PROMPT,
           "cache_len": FLASH_CACHE}

    # (a) prefill (the scan route) and greedy decode from its cache
    def run_prefill():
        return cuda_timed(lambda: prefill(cfg, params, {"tokens": tokens},
                                          FLASH_CACHE))

    ((logits, cache), out["prefill_ms"]), out["prefill_peak_bytes"] = \
        peak_above(run_prefill)
    _, out["prefill_ops"] = launching_ops(
        lambda: prefill(cfg, params, {"tokens": tokens}, FLASH_CACHE))
    rows, toks, out["decode_ms"] = [logits[0]], [int(logits[0].argmax())], []
    for i in range(FLASH_DECODE):
        step = torch.tensor([[toks[-1]]], dtype=torch.int32, device=dev)
        (lg, cache), ms = cuda_timed(
            lambda: decode_step(cfg, params, cache, step, FLASH_PROMPT + i))
        rows.append(lg[0])
        toks.append(int(lg[0].argmax()))
        out["decode_ms"].append(ms)
    del cache, logits
    r = types.SimpleNamespace(rid=0, prompt=prompt, out=toks)
    out["teacher_forced"], out["teacher_forced_peak_bytes"] = peak_above(
        lambda: teacher_forced(cfg, params, r, torch.stack(rows), dev))
    del rows

    # (b) the chunked route against whole rows at FLASH_AGREE tokens
    short = tokens[:, :FLASH_AGREE]
    routes = {}
    for route in ("chunked", "whole_rows"):
        ctx = (whole_row_attention() if route == "whole_rows"
               else contextlib.nullcontext())
        with ctx, torch.inference_mode():
            ((last, _), ms), peak = peak_above(lambda: cuda_timed(
                lambda: prefill(cfg, params, {"tokens": short},
                                FLASH_AGREE)))
            full, _ = train_logits(cfg, params, {"tokens": short})
        routes[route] = {"last": last[0].float(), "full": full[0],
                         "prefill_ms": ms, "prefill_peak_bytes": peak}
    got, want = routes["chunked"], routes["whole_rows"]
    scale = float(want["last"].abs().max())
    last_diff = float((got["last"] - want["last"]).abs().max())
    row_diff, decided, equal = [], [], []
    for a in range(0, FLASH_AGREE, 1024):       # f32 a block of rows at once
        g, w = (x["full"][a:a + 1024].float() for x in (got, want))
        row_diff.append((g - w).abs().amax(-1))
        top2 = w.topk(2, dim=-1).values
        decided.append(top2[:, 0] - top2[:, 1] > row_diff[-1])
        equal.append(g.argmax(-1) == w.argmax(-1))
    row_diff, decided, equal = (torch.cat(t) for t in (row_diff, decided,
                                                       equal))
    out["agreement"] = {
        "tokens": FLASH_AGREE, "last_max_abs_diff": last_diff,
        "last_max_abs_logit": scale,
        "tolerance": FLASH_AGREE_TOL * scale,
        "all_positions_max_abs_diff": float(row_diff.max()),
        "all_positions_max_abs_logit": float(want["full"].abs().max()),
        "decided_tokens": int(decided.sum()),
        "decided_tokens_equal": int((decided & equal).sum()),
        "tokens_equal": int(equal.sum()),
        **{f"{k}_{name}": v[name] for k, v in routes.items()
           for name in ("prefill_ms", "prefill_peak_bytes")}}
    require(last_diff <= FLASH_AGREE_TOL * scale,
            f"flash: the last position's logits differ by {last_diff}")
    require(bool((equal | ~decided).all()),
            f"flash: {int((decided & ~equal).sum())} decided tokens differ "
            "between the chunked and the whole-row routes")
    return out


def flash_train_path(dev, max_err) -> dict:
    """Phase 5g (c): FLASH_TRAIN_ARGS through the training CLI three times
    from one seed: fp32 on the vjp route, ``--rns-allreduce`` (one encode
    and one decode launch a step, step TRAIN_CHECK_STEP's kernels against
    their plain versions) and fp32 on the unrolled route; every loss
    finite, the codec's drift under TRAIN_MAX_DRIFT, and the vjp run's
    update within FLASH_UPDATE_TOL of the unrolled run's."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_params

    runs, launches, final = {}, Counter(), {}
    for label, flags, fields in (("vjp", (), {}),
                                 ("rns", ("--rns-allreduce",), {}),
                                 ("unrolled", (), {"attn_impl": "unrolled"})):
        with replaced_config(launch_train, **fields):
            r = train_run(dev, max_err, f"flash/{label}", flags,
                          TRAIN_CHECK_STEP if flags else None,
                          args=FLASH_TRAIN_ARGS, phase="flash_train")
        launches.update(r["launches"])
        runs[label] = {k: r["summary"][k] for k in
                       ("losses", "step_ms", "tokens_per_s",
                        "max_memory_allocated")}
        runs[label]["seconds"] = r["seconds"]
        if label != "rns":      # kept off the card while the others run
            final[label] = [p.cpu() for _, p in _named(r["params"])]
        del r
    drift = max(abs(a - b) for a, b in zip(runs["rns"]["losses"],
                                           runs["vjp"]["losses"]))
    require(drift < TRAIN_MAX_DRIFT, f"flash train: codec drift {drift}")
    free_card()
    theta0 = [p for _, p in _named(init_params(get_config(FLASH_ARCH), 0,
                                                 dev))]
    num = den = 0.0
    for a, b, c in zip(final["vjp"], final["unrolled"], theta0):
        a, b = (t.to(dev, torch.float64) for t in (a, b))
        num += float((a - b).square().sum())
        den += float((b - c.double()).square().sum())
    ratio = math.sqrt(num / den)
    require(ratio <= FLASH_UPDATE_TOL,
            f"flash train: the vjp run's update is {ratio} of the unrolled "
            "run's away from it")
    del final, theta0
    return {"runs": runs, "codec_drift": drift,
            "update_ratio_vjp_vs_unrolled": ratio,
            "update_tolerance": FLASH_UPDATE_TOL,
            "step1_loss_equal": (runs["vjp"]["losses"][0]
                                 == runs["unrolled"]["losses"][0]),
            "launches": implied(**launches)}


def flash_main_path(dev, max_err) -> dict:
    """Phase 5g: (a) and (b) (``flash_prefill_path``), (c)
    (``flash_train_path``); (d) runs inside 5f's ``mesh_dryrun``."""
    t0 = time.perf_counter()
    free_card()
    serve = flash_prefill_path(dev)
    train = flash_train_path(dev, max_err)
    return {**serve, "train": train, "launches": train["launches"],
            "seconds": time.perf_counter() - t0}


# ------------------------------------------------ slice 3: the crypto lane
def pow_chunk(items):
    """The oracle of a chunk of modexps, in a worker process."""
    return [pow(a, e, n) for a, e, n in items]


def odd_moduli(ctx, count: int, rng, bits: int | None = None) -> list:
    """``count`` odd moduli coprime to M·M': with ``bits``, of that many
    bits with the top bit set; otherwise uniform below n_max, the first
    the largest valid one."""
    MMp = ctx.baseB.M * ctx.baseBp.M
    out = []
    if bits is None:
        top = ctx.n_max - 1
        while top % 2 == 0 or math.gcd(top, MMp) != 1:
            top -= 1
        out.append(top)
    while len(out) < count:
        N = ((rng.getrandbits(bits) | 1 << (bits - 1)) if bits
             else rng.randrange(5, ctx.n_max)) | 1
        if math.gcd(N, MMp) == 1:
            out.append(N)
    return out


def crypto_columns(ctx, batch: int, rng, dev):
    """Channel-major int32 operands of one parity case on ``dev``: x and y
    (both bases) below 2N, and the rows neg and nhi of a different N in each
    column (the first just below n_max).  x takes the corners 0, 1, N-1,
    N, 2N-1 on its first columns, y on its last ones."""
    import torch

    B, Bp = ctx.baseB, ctx.baseBp
    Ns = odd_moduli(ctx, batch, rng)
    xs = [rng.randrange(2 * N) for N in Ns]
    ys = [rng.randrange(2 * N) for N in Ns]
    corners = (lambda N: 0, lambda N: 1, lambda N: N - 1, lambda N: N,
               lambda N: 2 * N - 1)
    for i, f in enumerate(corners[:batch]):
        xs[i] = f(Ns[i])
        ys[-1 - i] = f(Ns[-1 - i])

    def tile(rows):
        return torch.tensor(rows, dtype=torch.int32).T.contiguous().to(dev)

    lo = lambda vs: tile([[v % t for t in ctx.lo_targets] for v in vs])
    hi = lambda vs: tile([[v % m for m in Bp.moduli] for v in vs])
    neg = tile([[(-pow(N, -1, m)) % m for m in B.moduli] for N in Ns])
    nhi = tile([[N % m for m in Bp.moduli] for N in Ns])
    return lo(xs), hi(xs), lo(ys), hi(ys), neg, nhi


def crypto_parity(dev, max_err) -> dict:
    """Both Montgomery kernels against their plain versions over the sweep,
    bit for bit on every channel, the redundant ones included."""
    import torch

    from repro_torch.core import Layout
    from repro_torch.kernels import ops
    from repro_torch.kernels.mont_ladder import (mont_ladder_kernel_call,
                                                 mont_ladder_plain,
                                                 mont_mul_kernel_call,
                                                 mont_mul_plain)
    from repro_torch.serve.crypto import CryptoContext

    rng = random.Random(13)
    gen = torch.Generator(device=dev).manual_seed(13)

    def hold(name, got, want, where):
        for g, w in zip(got, want):
            err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
            max_err[name] = max(max_err[name], err)
            require(g.shape == w.shape and err == 0,
                    f"{name} kernel disagrees with its plain version at {where}")

    cases = []
    for n_limbs in CRYPTO_SWEEP_LIMBS:
        layouts = [Layout.BASE_MA] + ([Layout.RRNS]
                                      if n_limbs in CRYPTO_RRNS_LIMBS else [])
        for layout in layouts:
            ctx = CryptoContext(n_limbs=n_limbs, exp_bits=8, layout=layout)
            tables = ops._mont_tables(ctx.baseB, ctx.baseBp, ctx.lo_targets,
                                      dev)
            image = ops._mont_image(ctx.baseB, ctx.baseBp, ctx.lo_targets,
                                    dev)
            for batch in CRYPTO_BATCHES:
                where = dict(n_limbs=n_limbs, layout=layout.value, batch=batch)
                cols = crypto_columns(ctx, batch, rng, dev)
                hold("mont_mul", mont_mul_kernel_call(*cols, image),
                     mont_mul_plain(*cols, *tables), where)
                rows = {"zeros": torch.zeros(batch, dtype=torch.int32,
                                             device=dev),
                        "ones": torch.ones(batch, dtype=torch.int32,
                                           device=dev),
                        "mixed": torch.randint(0, 2, (batch,), generator=gen,
                                               device=dev, dtype=torch.int32)}
                xl, xh, yl, yh, neg, nhi = cols
                for label, bit in rows.items():
                    args = (xl, xh, yl, yh, bit, neg, nhi)
                    hold("mont_ladder", mont_ladder_kernel_call(*args, image),
                         mont_ladder_plain(*args, *tables),
                         dict(where, bits=label))
                cases.append(where)
    torch.cuda.synchronize()
    return {"cases": len(cases), "n_limbs": list(CRYPTO_SWEEP_LIMBS),
            "rrns_n_limbs": list(CRYPTO_RRNS_LIMBS),
            "batches": list(CRYPTO_BATCHES), "bit_rows": 3}


def crypto_requests(ctx, rng) -> list:
    """The lane's traffic: CRYPTO_MODEXPS non-CRT RSA private-key modexps
    (an odd RSA_BITS-bit modulus with the top bit set, coprime to M·M'; a
    base below N; an exponent uniform over RSA_BITS bits), with the modmuls
    and the divmods spread evenly among them."""
    from repro_torch.serve.crypto import CryptoRequest

    M, reqs = ctx.baseB.M, []
    Ns = odd_moduli(ctx, CRYPTO_MODEXPS + CRYPTO_MODMULS, rng, RSA_BITS)
    mm_every = CRYPTO_MODEXPS // CRYPTO_MODMULS
    dm_every = CRYPTO_MODEXPS // CRYPTO_DIVMODS
    for i in range(1, CRYPTO_MODEXPS + 1):
        N = Ns[i - 1]
        reqs.append(CryptoRequest(rid=len(reqs), op="modexp",
                                  a=rng.randrange(N),
                                  b=rng.getrandbits(RSA_BITS), n=N))
        if i % mm_every == 0:
            N = Ns[CRYPTO_MODEXPS + i // mm_every - 1]
            reqs.append(CryptoRequest(rid=len(reqs), op="modmul",
                                      a=rng.randrange(N), b=rng.randrange(N),
                                      n=N))
        if i % dm_every == 0:
            reqs.append(CryptoRequest(rid=len(reqs), op="divmod",
                                      a=rng.randrange(M),
                                      b=rng.randrange(1, M)))
    return reqs


def crypto_main_path(dev) -> dict:
    """Slice 3's main path: the crypto lane at RSA-2048 width through
    ``CryptoEngine.run_to_completion``, with the launch counts read just
    around it; then the oracle, the fingerprints and a wire repair."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve.batcher import CryptoEngine
    from repro_torch.serve.crypto import CryptoContext

    ctx = CryptoContext(n_limbs=CRYPTO_LIMBS, exp_bits=CRYPTO_EXP_BITS)
    reqs = crypto_requests(ctx, random.Random(2048))
    eng = CryptoEngine(crypto_slots=CRYPTO_SLOTS, crypto_ctx=ctx,
                       crypto_chunk=CRYPTO_CHUNK, rns_verify=True, device=dev)
    for r in reqs:
        eng.submit(r)
    # Instrumentation: CUDA events around each tick's ladder advance (the
    # lane function ``step``: from its first launch's enqueue to its last
    # kernel's end) and the host clock around the same call (the time the
    # host takes to enqueue it: the call does not wait for the card; where
    # it is as long as the events' span, the card waited for the host),
    # and the host clock around each per-request call (modmul, divmod and the retirement end in a host
    # read of the result, so the clock sees their device work; a bind does
    # not wait for the card).
    ticks, tick_host = [], []
    host = {"bind": [], "modmul": [], "divmod": [], "retire": []}
    advance = eng._crypto_fns["step"]
    orig = {name: getattr(eng, "_crypto_" + name) for name in host}

    def timed_advance(*args):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        e0.record()
        out = advance(*args)
        e1.record()
        tick_host.append(time.perf_counter() - t)
        ticks.append((e0, e1))
        return out

    # each divmod also between two CUDA events (its span on the card; the
    # call ends in a host read, so the span holds all its device work) with
    # the compare launches it made
    divmods = []

    def clocked(name):
        def call(*args):
            if name == "divmod":
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                launched = ops.compare_op.launches
                e0.record()
            t = time.perf_counter()
            out = orig[name](*args)
            host[name].append(time.perf_counter() - t)
            if name == "divmod":
                e1.record()
                divmods.append((e0, e1, ops.compare_op.launches - launched))
            return out
        return call

    eng._crypto_fns["step"] = timed_advance
    for name in host:
        setattr(eng, "_crypto_" + name, clocked(name))
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = launch_counts(ops)
    eng._crypto_fns["step"] = advance
    for name in orig:
        delattr(eng, "_crypto_" + name)
    n_ticks = len(ticks)
    nbits = ctx.baseB.M.bit_length()
    want = implied(
        mont_ladder=n_ticks * CRYPTO_CHUNK,
        mont_mul=2 * CRYPTO_MODEXPS + 2 * CRYPTO_MODMULS,
        compare=CRYPTO_MODEXPS + CRYPTO_MODMULS
        + CRYPTO_DIVMODS * (2 * nbits + 1),
        codec_encode=2 * CRYPTO_MODEXPS)
    require(n_ticks == CRYPTO_EXP_BITS // CRYPTO_CHUNK,
            f"crypto lane took {n_ticks} ticks")
    require(got == want, f"crypto lane launches {got}, expected {want}")
    tick_ms = [a.elapsed_time(b) for a, b in ticks]

    # the oracle: pow() on a process pool, divmod and modmul inline
    require(sorted(r.rid for r in done) == [r.rid for r in reqs],
            "crypto lane: requests missing")
    modexps = [r for r in done if r.op == "modexp"]
    items = [(r.a, r.b, r.n) for r in modexps]
    workers = os.cpu_count() or 1
    t1 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")
                             ) as pool:
        chunks = [items[i : i + ORACLE_CHUNK]
                  for i in range(0, len(items), ORACLE_CHUNK)]
        pows = [v for part in pool.map(pow_chunk, chunks) for v in part]
    oracle_s = time.perf_counter() - t1
    for r, v in zip(modexps, pows):
        require(r.result == v, f"crypto lane: modexp rid {r.rid} differs "
                "from pow()")
    for r in done:
        if r.op == "modmul":
            require(r.result == r.a * r.b % r.n,
                    f"crypto lane: modmul rid {r.rid} differs")
        elif r.op == "divmod":
            require(r.result == divmod(r.a, r.b),
                    f"crypto lane: divmod rid {r.rid} differs")

    # fingerprints: verified at every retirement, and again now (no slot
    # was reused); then one stored codeword corrupted and repaired
    require(len(eng.verify_log) == len(reqs)
            and all(eng.verify_log.values()),
            "crypto lane: a retirement failed its fingerprint")
    reverified = sum(eng.verify_request(r) for r in modexps)
    require(reverified == CRYPTO_MODEXPS, "crypto lane: re-verification")
    key = ("crypto", modexps[0].rid)
    require(eng.wire_ok(key), "crypto lane: a clean codeword fails")
    eng.corrupt_wire(key, channel=1, delta=3)
    detected = not eng.wire_ok(key)
    repair = eng.repair_wire(key)
    require(detected and repair == {"repaired": 1, "unrecoverable": 0}
            and eng.wire_ok(key) and eng.verify_request(modexps[0]),
            f"crypto lane: corruption detected {detected}, repair {repair}")
    return {"n_limbs": CRYPTO_LIMBS, "exp_bits": CRYPTO_EXP_BITS,
            "nch_lo": ctx.nch_lo, "n_hi": ctx.n_hi,
            "range_bits": ctx.baseB.M.bit_length(),
            "slots": CRYPTO_SLOTS, "chunk": CRYPTO_CHUNK,
            "requests": {"modexp": CRYPTO_MODEXPS, "modmul": CRYPTO_MODMULS,
                         "divmod": CRYPTO_DIVMODS},
            "ticks": n_ticks, "seconds": seconds,
            "modexp_per_s": CRYPTO_MODEXPS / seconds,
            "tick_ms_median": statistics.median(tick_ms),
            "tick_ms_total": sum(tick_ms),
            "tick_host_ms_median": 1e3 * statistics.median(tick_host),
            "host_s": {k: sum(v) for k, v in host.items()},
            "host_ms": {k: {"median": 1e3 * statistics.median(v),
                            "max": 1e3 * max(v), "first": 1e3 * v[0]}
                        for k, v in host.items() if v},
            "launches": got,
            "divmod": {"host_ms": [1e3 * v for v in host["divmod"]],
                       "device_span_ms": [a.elapsed_time(b)
                                          for a, b, _ in divmods],
                       "compare_launches": [k for _, _, k in divmods]},
            "oracle_ok": len(done), "oracle_s": oracle_s,
            "oracle_workers": workers, "verified": len(eng.verify_log),
            "reverified": reverified, "injected_detected": detected,
            "injected_repair": repair}


def crypto_frontends(dev) -> dict:
    """``RNSMontgomery`` modexp and modmul on one RSA-2048 N against pow(),
    and the ``rns_modmul`` example, each with the launches it implies."""
    from repro_torch import rns_modmul
    from repro_torch.core.montgomery import RNSMontgomery
    from repro_torch.kernels import ops
    from repro_torch.serve.crypto import CryptoContext

    ctx = CryptoContext(n_limbs=CRYPTO_LIMBS, exp_bits=CRYPTO_EXP_BITS)
    rng = random.Random(4096)
    N = odd_moduli(ctx, 1, rng, RSA_BITS)[0]
    mont = RNSMontgomery(ctx.baseB, ctx.baseBp, N, device=dev)
    a, b, e = rng.randrange(N), rng.randrange(N), rng.getrandbits(RSA_BITS)
    ops.reset_launches()
    t0 = time.perf_counter()
    require(mont.modexp(a, e) == pow(a, e, N), "RNSMontgomery.modexp")
    modexp_s = time.perf_counter() - t0
    got = launch_counts(ops)
    require(got == implied(mont_ladder=e.bit_length(), mont_mul=2, compare=1),
            f"RNSMontgomery.modexp launches {got}")
    ops.reset_launches()
    require(mont.modmul(a, b) == a * b % N, "RNSMontgomery.modmul")
    require(launch_counts(ops) == implied(mont_mul=2, compare=1),
            "RNSMontgomery.modmul launches")
    ops.reset_launches()
    t0 = time.perf_counter()
    ex = rns_modmul.main(dev, verbose=False)
    example_s = time.perf_counter() - t0
    require(ex["got"] == ex["want"], "rns_modmul example")
    # 6 squares, 4 multiplies and the exit for E = 0b101101; one compare
    got_ex = launch_counts(ops)
    require(got_ex == implied(mont_mul=11, compare=1),
            f"rns_modmul launches {got_ex}")
    return {"modexp_s": modexp_s, "exp_bits": e.bit_length(),
            "modexp_launches": got, "example_s": example_s,
            "example_launches": got_ex}


# ---------------------------------------------- slice 5: the LLM serve lane
class ServeProbe:
    """Instrumentation of ``repro_torch.serve.batcher`` around one run of
    the serve driver.  It wraps the model calls the engine makes (the
    module's ``decode_step`` and ``extend_step``), four engine methods
    (``submit``, ``_prefill_into``, ``step``, ``_retire_paged``) and the
    wire store's ``put``: CUDA events and the host clock around each decode
    step (the events' span is the step; the host clock is the time to
    enqueue it, the call does not wait for the card) and around each
    prefill chunk; for each rid in ``keep_logits`` a copy of its logit row
    from its admission's last chunk and from each decode step (kept on the
    card, for the teacher-forced check); the wall time of each submit and
    first token (TTFT in ms; the first token ends in a host read); at the
    retirement of each rid in ``keep_rows`` a copy of its written KV span
    [0, plen + n_out - 1) (on a paged pool the logical rows gathered
    through its page-table row, before the row is released); on a paged
    pool before each step the pages the slots' tables map (a shared page
    once per reader: what the same slots would hold without sharing)
    beside the pages in use; and the codewords put under int keys (one a
    page on a paged pool)."""

    def __init__(self, keep_rows=(), keep_logits=()):
        from repro_torch.serve import batcher

        self.batcher, self.keep_rows = batcher, set(keep_rows)
        self.keep_logits = set(keep_logits)
        self.decode, self.decode_host, self.chunks = [], [], []
        self.logits = {rid: [] for rid in self.keep_logits}
        self.prefill_logits = {}
        self.t_submit, self.t_first, self.rows = {}, {}, {}
        self.engine, self.prefilling = None, None
        self.page_use, self.page_puts = [], 0

    def __enter__(self):
        from repro_torch.dist import fault

        B = self.batcher.ContinuousBatcher
        self.store = fault.WireStore
        self.orig = {"decode_step": self.batcher.decode_step,
                     "extend_step": self.batcher.extend_step,
                     "submit": B.submit, "_prefill_into": B._prefill_into,
                     "step": B.step, "_retire_paged": B._retire_paged,
                     "put": self.store.put}
        probe = self

        def submit(eng, req):
            probe.t_submit[req.rid] = time.perf_counter()
            return probe.orig["submit"](eng, req)

        def prefill_into(eng, slot, now):
            probe.prefilling = slot.req.rid
            out = probe.orig["_prefill_into"](eng, slot, now)
            probe.t_first[probe.prefilling] = time.perf_counter()
            return out

        def step(eng, now=0.0):
            probe.engine = eng
            if eng.paged:
                probe.page_use.append(
                    (sum(p != 0 for row in eng.sched.table for p in row),
                     eng.sched.alloc.in_use))
            retired = probe.orig["step"](eng, now)
            for r in retired:
                if r.rid in probe.keep_rows and not eng.paged:
                    end = len(r.prompt) + len(r.out) - 1
                    probe.rows[r.rid] = tuple(
                        eng.cache[n][:, r.slot_index, :end].clone()
                        for n in ("k", "v"))
            return retired

        def retire_paged(eng, req):
            if req.rid in probe.keep_rows:
                end = len(req.prompt) + len(req.out) - 1
                pages = eng._table(eng.sched.table[req.slot_index])
                rows = []
                for n in ("k", "v"):
                    pool = eng.cache[n]
                    L, _, ps, g, hd = pool.shape
                    rows.append(pool[:, pages].reshape(
                        L, len(pages) * ps, g, hd)[:, :end].clone())
                probe.rows[req.rid] = tuple(rows)
            return probe.orig["_retire_paged"](eng, req)

        def put(store, key, arr):
            probe.page_puts += isinstance(key, int)
            return probe.orig["put"](store, key, arr)

        self.batcher.decode_step = self._decode_step
        self.batcher.extend_step = self._extend_step
        B.submit, B._prefill_into, B.step = submit, prefill_into, step
        B._retire_paged, self.store.put = retire_paged, put
        return self

    def __exit__(self, *exc):
        B = self.batcher.ContinuousBatcher
        self.batcher.decode_step = self.orig["decode_step"]
        self.batcher.extend_step = self.orig["extend_step"]
        for name in ("submit", "_prefill_into", "step", "_retire_paged"):
            setattr(B, name, self.orig[name])
        self.store.put = self.orig["put"]

    def _timed(self, fn, *args, **kw):
        import torch

        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        e0.record()
        out = fn(*args, **kw)
        e1.record()
        return out, (e0, e1), time.perf_counter() - t

    def _decode_step(self, cfg, params, cache, tokens, pos, **kw):
        (logits, cache), ev, host = self._timed(
            self.orig["decode_step"], cfg, params, cache, tokens, pos, **kw)
        self.decode.append(ev)
        self.decode_host.append(host)
        for s in self.engine.sched.slots:
            if s.state == "DECODE" and s.req.rid in self.keep_logits:
                self.logits[s.req.rid].append(logits[s.index].clone())
        return logits, cache

    def _extend_step(self, cfg, params, cache, tokens, pos, **kw):
        (logits, cache), ev, _ = self._timed(
            self.orig["extend_step"], cfg, params, cache, tokens, pos, **kw)
        self.chunks.append(ev)
        if self.prefilling in self.keep_logits:
            self.prefill_logits[self.prefilling] = logits[0, 0].clone()
        return logits, cache

    def logits_of(self, rid):
        """The engine's logit rows of ``rid``, in order: the admission's
        last prompt position, then each decode step's row."""
        import torch

        return torch.stack([self.prefill_logits[rid], *self.logits[rid]])


def serve_run(argv, keep_rows=(), keep_logits=()):
    """One run of ``repro_torch.launch.serve.main`` on ``argv`` under a
    ServeProbe, its printed report captured and checked against the one it
    returns; the launch counts set to 0 just before it and read just after,
    and the peak device memory of the run above what was allocated when it
    started (the earlier phases' live tensors)."""
    import contextlib
    import io

    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    out = io.StringIO()
    ops.reset_launches()
    with ServeProbe(keep_rows, keep_logits) as probe, \
            contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        report, engine = launch_serve.main(list(argv))
        seconds = time.perf_counter() - t0
    launches = launch_counts(ops)
    printed = out.getvalue()
    # --mode offline|loadgen print '# ...' progress lines before the report
    start = 0 if printed.startswith("{") else printed.index("\n{") + 1
    require(json.JSONDecoder().raw_decode(printed[start:])[0] == report,
            "serve: the CLI's printed report")
    return {"report": report, "engine": engine, "probe": probe,
            "seconds": seconds, "launches": launches,
            "memory_allocated_at_start": at_start,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "peak_memory_of_run": torch.cuda.max_memory_allocated() - at_start}


def teacher_forced(cfg, params, r, got, dev, stubs=None, held=True,
                   pad_to=ATTN_CHUNK) -> dict:
    """Request ``r``'s engine logits ``got`` (the last prompt position, then
    each decode step) against a teacher-forced ``train_logits`` over
    prompt + out[:-1] (with ``stubs``, the request's vlm patches or encdec
    frames; padded at the end so that the patches and tokens make a
    multiple of ``pad_to``, the attention's chunk, which causality keeps
    out of every compared position): within
    SERVE_LOGIT_TOL of the forward's largest |logit|, and every token
    whose top-2 margin there exceeds the difference equal to the forward's
    argmax.  With ``held`` false both are measured, not required."""
    import torch

    from repro_torch.models import train_logits

    plen = len(r.prompt)
    with torch.inference_mode():
        seq = r.prompt + r.out[:-1]
        prefix = (stubs or {}).get("patches")     # the vlm patches go first
        pad = -(len(seq) + (0 if prefix is None else prefix.shape[1])
                ) % pad_to
        batch = {"tokens": torch.tensor([seq + [0] * pad], device=dev)}
        batch.update(stubs or {})
        fwd, _ = train_logits(cfg, params, batch)
        fwd = fwd[0, plen - 1:plen - 1 + len(r.out)].float()
        got = got.float()
        require(got.shape == fwd.shape,
                f"serve: rid {r.rid} logits {tuple(got.shape)}")
        row_diff = (got - fwd).abs().amax(dim=-1)
        diff = float(row_diff.max())
        scale = float(fwd.abs().max())
        past = int((row_diff > SERVE_LOGIT_TOL * scale).sum())
        top2 = fwd.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        argmax = fwd.argmax(dim=-1).tolist()
    decided = [i for i in range(len(r.out)) if float(margin[i]) > diff]
    agree = sum(r.out[i] == argmax[i] for i in decided)
    require(not held or diff <= SERVE_LOGIT_TOL * scale,
            f"serve: rid {r.rid} logits differ by {diff}")
    require(not held or agree == len(decided),
            f"serve: rid {r.rid}: {len(decided) - agree} decided tokens "
            "differ from the forward's argmax")
    return {"rid": r.rid, "plen": plen, "positions": len(r.out),
            "padded_to": len(seq) + pad, "max_abs_diff": diff,
            "max_abs_logit": scale,
            "tolerance": SERVE_LOGIT_TOL * scale,
            "positions_past_tolerance": past,
            "decided_tokens": len(decided),
            "decided_tokens_equal": agree,
            "argmax_equal_all": argmax == r.out, "held": held}


def serve_main_path(dev, max_err) -> dict:
    """Slice 5's main path: gemma3-1b at full width through the serve CLI
    (SERVE_ARGS), its report and fingerprints checked; the codec_encode
    kernel on one real fingerprint against its plain version; three
    requests re-run alone through a fresh engine of the same shape (tokens
    and KV rows bit for bit); two requests' engine logits against a
    teacher-forced forward; the host and card times of the path; then a
    short mixed llm,crypto run against Python's big ints."""
    import torch

    from repro_torch.kernels.codec_encode import (codec_encode_kernel_call,
                                                  codec_encode_plain)
    from repro_torch.serve.batcher import ContinuousBatcher
    from repro_torch.serve.offline import pow2_buckets
    from repro_torch.serve.scheduler import Request

    run = serve_run(SERVE_ARGS, keep_rows=SERVE_SOLO_RIDS,
                    keep_logits=SERVE_CHECK_RIDS)
    rep, eng, probe = run["report"], run["engine"], run["probe"]
    n_req = int(SERVE_ARGS[SERVE_ARGS.index("--requests") + 1])
    max_new = int(SERVE_ARGS[SERVE_ARGS.index("--max-new") + 1])
    require(rep["requests"] == n_req and rep["tokens_out"] == n_req * max_new,
            f"serve: {rep['requests']} requests, {rep['tokens_out']} tokens")
    require(set(rep["jit_traces"].values()) == {1},
            f"serve: jit_traces {rep['jit_traces']}")
    rns = rep["rns"]
    require(rns["slots_verified"] == n_req and rns["slots_failed"] == 0
            and rns["wire_ok"] == n_req, f"serve: rns {rns}")
    require(rns["injected_detected"] and rns["injected_reverified"]
            and rns["injected_repair"] == {"repaired": 1,
                                           "unrecoverable": 0},
            f"serve: injected wire fault {rns}")
    # one fingerprint encode per admission and per retirement
    require(run["launches"]["codec_encode"] == 2 * n_req,
            f"serve: launches {run['launches']}")

    # the kernel on one real fingerprint (the last retired row is intact)
    last = eng.sched.completed[-1]
    fp = eng._fp_fn(eng.cache, last.slot_index, len(last.prompt))
    enc, enc_kw, _, _ = codec_tables(eng.codec)
    got = codec_encode_kernel_call(fp, *enc, **enc_kw)
    want = codec_encode_plain(fp, *enc, **enc_kw)
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    max_err["codec_encode"] = max(max_err["codec_encode"], err)
    require(err == 0 and torch.equal(got, want),
            "serve: codec_encode on a fingerprint differs from its plain "
            "version")
    require(eng.verify_request(last), "serve: re-verify the last request")
    fp_ms = median_ms(lambda: eng.codec.encode_array(
        eng._fp_fn(eng.cache, last.slot_index, len(last.prompt)),
        channel_major=True))

    # batching invariance: the same requests alone, on a fresh engine
    done = {r.rid: r for r in eng.sched.completed}
    cfg, params = eng.cfg, eng.params
    solo = ContinuousBatcher(
        cfg, params, n_slots=eng.sched.n_slots, cache_len=eng.sched.cache_len,
        prefill_chunk=eng.prefill_chunk, rns_verify=True)
    invariance = []
    for rid in SERVE_SOLO_RIDS:
        r = done[rid]
        alone = Request(rid=rid, prompt=list(r.prompt), max_new=r.max_new)
        solo.submit(alone)
        solo.run_to_completion()
        end = len(r.prompt) + len(r.out) - 1
        rows = tuple(solo.cache[n][:, alone.slot_index, :end]
                     for n in ("k", "v"))
        same_tokens = alone.out == r.out
        same_rows = all(torch.equal(a, b)
                        for a, b in zip(rows, probe.rows[rid]))
        require(same_tokens, f"serve: rid {rid} alone gives other tokens")
        require(same_rows, f"serve: rid {rid} alone gives other KV rows")
        require(solo.verify_log[rid], f"serve: rid {rid} alone verifies")
        invariance.append({"rid": rid, "plen": len(r.prompt),
                           "slot_mixed": r.slot_index,
                           "tokens_equal": same_tokens,
                           "kv_rows_bitwise": same_rows})
    require(set(solo.jit_cache_sizes().values()) == {1},
            "serve: the solo engine's census")
    del solo

    # bucketed prefill on the batched cache: the same requests alone on a
    # fresh engine with pow2 buckets (one padded extend call a prompt),
    # tokens and KV rows bit for bit against the chunk loop's
    bucketed = ContinuousBatcher(
        cfg, params, n_slots=eng.sched.n_slots, cache_len=eng.sched.cache_len,
        prefill_chunk=eng.prefill_chunk, rns_verify=True,
        prefill_buckets=pow2_buckets(eng.sched.cache_len))
    bucket_rows = []
    for rid in SERVE_SOLO_RIDS:
        r = done[rid]
        alone = Request(rid=rid, prompt=list(r.prompt), max_new=r.max_new)
        bucketed.submit(alone)
        bucketed.run_to_completion()
        end = len(r.prompt) + len(r.out) - 1
        rows = tuple(bucketed.cache[n][:, alone.slot_index, :end]
                     for n in ("k", "v"))
        same_tokens = alone.out == r.out
        same_rows = all(torch.equal(a, b)
                        for a, b in zip(rows, probe.rows[rid]))
        bucket_rows.append({
            "rid": rid, "plen": len(r.prompt),
            "bucket": bucketed._pick_bucket(len(r.prompt)),
            "tokens_equal": same_tokens, "kv_rows_bitwise": same_rows,
            "max_abs_diff": max(float((a.float() - b.float()).abs().max())
                                for a, b in zip(rows, probe.rows[rid]))})
        require(same_tokens and same_rows,
                f"serve: rid {rid}'s bucketed prefill differs from the "
                f"chunk loop: {bucket_rows[-1]}")
        require(bucketed.verify_log[rid],
                f"serve: rid {rid} bucketed verifies")
    require(bucketed.bucket_stats()["fallbacks"] == 0,
            f"serve: bucketed fallbacks {bucketed.bucket_stats()}")
    del bucketed

    # cache consistency: the engine's logits against a teacher-forced
    # forward over prompt + out[:-1]
    consistency = [teacher_forced(cfg, params, done[rid],
                                  probe.logits_of(rid), dev)
                   for rid in SERVE_CHECK_RIDS]

    decode_ms = [a.elapsed_time(b) for a, b in probe.decode]
    chunk_ms = [a.elapsed_time(b) for a, b in probe.chunks]
    ttft_ms = [1e3 * (probe.t_first[k] - probe.t_submit[k])
               for k in probe.t_first]
    main_run = {
        "seconds": run["seconds"], "wall_s": rep["wall_s"],
        "tok_per_s": rep["tok_per_s"], "steps": rep["steps"],
        "max_concurrency": rep["max_concurrency"],
        "decode_steps": len(decode_ms),
        "decode_ms_median": statistics.median(decode_ms),
        "decode_ms_max": max(decode_ms),
        "decode_host_ms_median": 1e3 * statistics.median(probe.decode_host),
        "prefill_chunks": len(chunk_ms),
        "prefill_chunk_ms_median": statistics.median(chunk_ms),
        "ttft_ticks": rep["ttft_ticks"],
        "ttft_ms": {"median": statistics.median(ttft_ms),
                    "max": max(ttft_ms)},
        "fingerprint_ms": fp_ms, "jit_traces": rep["jit_traces"],
        "rns": rns, "launches": run["launches"],
        **{k: run[k] for k in ("memory_allocated_at_start",
                               "max_memory_allocated", "peak_memory_of_run")},
        "invariance": invariance, "bucketed_vs_chunk_loop": bucket_rows,
        "consistency": consistency}
    del eng, probe, run, params

    # the mixed families: a short llm,crypto run
    mixed = serve_run(SERVE_MIXED_ARGS)
    mrep = mixed["report"]
    n_crypto = int(SERVE_MIXED_ARGS[
        SERVE_MIXED_ARGS.index("--crypto-requests") + 1])
    require(mrep["crypto"]["oracle_ok"] == n_crypto
            and mrep["crypto"]["oracle_failed"] == 0,
            f"serve: mixed crypto {mrep['crypto']}")
    require(mrep["rns"]["slots_failed"] == 0
            and mrep["rns"]["slots_verified"] == mrep["requests"],
            f"serve: mixed rns {mrep['rns']}")
    require(set(mrep["jit_traces"].values()) <= {0, 1},
            f"serve: mixed jit_traces {mrep['jit_traces']}")
    del mixed["engine"]
    total = Counter(main_run["launches"])
    total.update(mixed["launches"])
    return {"main": main_run,
            "mixed": {"seconds": mixed["seconds"], "requests":
                      mrep["requests"], "crypto": mrep["crypto"],
                      "rns": mrep["rns"], "jit_traces": mrep["jit_traces"],
                      "launches": mixed["launches"]},
            "launches": implied(**total)}


# ----------------------------------------------- slice 6: the paged pool
def paged_trace(path: str, engine=PAGED_ENGINE, shared=PAGED_SHARED,
                bare=PAGED_BARE, max_new=PAGED_MAX_NEW) -> list:
    """Write phase 6c's JSONL workload (the serve CLI's ``--trace``
    format), token ids drawn below the vocabulary of ``engine``'s arch,
    and return its requests as dicts: ``shared`` requests behind the
    prefix, then ``bare`` ones of the bare prefix (6g takes the first
    requests of the same draws)."""
    import numpy as np

    from repro_torch.configs import get_config

    cfg = get_config(engine[engine.index("--arch") + 1])
    vocab = (cfg if "--no-smoke" in engine else cfg.smoke()).vocab
    rng = np.random.default_rng(0)
    prefix = [int(t) for t in rng.integers(1, vocab, PAGED_PREFIX)]
    t, reqs = 0.0, []
    for rid in range(shared + bare):
        t += float(rng.exponential(1.0 / PAGED_RATE))
        if rid < shared:
            n = max(1, int(rng.poisson(PAGED_SUFFIX_MEAN)))
            prompt = prefix + [int(x) for x in rng.integers(1, vocab, n)]
        else:
            prompt = list(prefix)
        reqs.append({"rid": rid, "prompt": prompt, "max_new": max_new,
                     "eos": None, "arrival": t})
    with open(path, "w") as f:
        for r in reqs:
            f.write(json.dumps(r) + "\n")
    return reqs


def step_times(probe) -> dict:
    """A run's decode-step and prefill-call times: CUDA events (median,
    max) and the host's time to enqueue a decode step (median)."""
    decode = [a.elapsed_time(b) for a, b in probe.decode]
    chunks = [a.elapsed_time(b) for a, b in probe.chunks]
    return {"decode_steps": len(decode),
            "decode_ms_median": statistics.median(decode),
            "decode_ms_max": max(decode),
            "decode_host_ms_median": 1e3 * statistics.median(
                probe.decode_host),
            "prefill_calls": len(chunks),
            "prefill_call_ms_median": statistics.median(chunks)}


def paged_main_path(dev, max_err) -> dict:
    """Slice 6's main path, gemma3-1b at full width on the paged pool:
    (a) the sim CLI with pages of 512 on the shared-prefix trace, its
    dedup, copy-on-write, page and codeword counts checked and its
    injected fault repaired; a shared page corrupted under three live
    readers, repaired once, every reader re-verified; the codec_encode
    kernel on a real page fingerprint against its plain version; (b) the
    same trace on the batched cache: tokens and three requests' logical
    K/V rows equal bit for bit, the decode step and prefill chunk timed
    beside the paged ones; (c) ``--mode offline`` with pow2 buckets on the
    trace: steady state, fingerprints, wall-clock numbers, tokens against
    (a) and two requests against a teacher-forced forward; (d) the mixed
    ``llm,crypto`` workload offline; (e) ``--mode loadgen``."""
    import torch

    from repro_torch.kernels.codec_encode import (codec_encode_kernel_call,
                                                  codec_encode_plain)
    from repro_torch.serve.scheduler import Request

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "paged_trace.jsonl")
    trace = paged_trace(path)
    n_req = len(trace)
    tokens = n_req * PAGED_MAX_NEW
    ps = int(PAGED_SIM[PAGED_SIM.index("--page-size") + 1])

    # (a) the paged sim
    a = serve_run(PAGED_ENGINE + PAGED_SIM + ("--trace", path),
                  keep_rows=PAGED_ROW_RIDS)
    rep, eng, probe = a["report"], a["engine"], a["probe"]
    require(rep["requests"] == n_req and rep["tokens_out"] == tokens,
            f"paged sim: {rep['requests']} requests, {rep['tokens_out']} "
            f"tokens")
    require(set(rep["jit_traces"].values()) == {1},
            f"paged sim: jit_traces {rep['jit_traces']}")
    pg, rns = rep["paging"], rep["rns"]
    require(pg["dedup_hits"] > 0 and pg["cow_copies"] > 0,
            f"paged sim: paging {pg}")
    mapped = max(m for m, _ in probe.page_use)
    in_use = max(u for _, u in probe.page_use)
    require(in_use < mapped and pg["pages_in_use_peak"] < mapped,
            f"paged sim: {in_use} pages in use against {mapped} unshared")
    # one codeword a page, not one a reader: a reader's prompt pages less
    # the shared ones it mapped, plus the ones it copied
    reader_pages = sum(-(-len(r["prompt"]) // ps) for r in trace)
    puts = probe.page_puts
    require(puts == reader_pages - pg["dedup_hits"] + pg["cow_copies"]
            and puts < reader_pages,
            f"paged sim: {puts} codewords for {reader_pages} reader pages")
    require(rns["slots_verified"] == n_req and rns["slots_failed"] == 0
            and pg["fingerprints"]["failed"] == 0, f"paged sim: rns {rns}")
    require(rns["injected_detected"] and rns["injected_reverified"]
            and rns["injected_repair"] == {"repaired": 1,
                                           "unrecoverable": 0},
            f"paged sim: injected wire fault {rns}")
    retained = sorted(eng.sched.alloc.retained)
    require(retained and all(eng.sched.alloc.refcount[p] == 0
                             for p in retained),
            f"paged sim: retained pages {retained}")

    # the codec_encode kernel on a real page fingerprint
    pid = retained[0]
    fp = eng._fp_fn(eng.cache, pid, eng._page_span[pid])
    enc, enc_kw, _, _ = codec_tables(eng.codec)
    got = codec_encode_kernel_call(fp, *enc, **enc_kw)
    want = codec_encode_plain(fp, *enc, **enc_kw)
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    max_err["codec_encode"] = max(max_err["codec_encode"], err)
    require(err == 0 and torch.equal(got, want),
            "paged: codec_encode on a page fingerprint differs from its "
            "plain version")
    page_fp_ms = median_ms(lambda: eng._page_codeword(pid))

    # a shared page corrupted under three live readers: repaired once,
    # every reader re-verified
    prefix = trace[0]["prompt"][:PAGED_PREFIX]
    readers = [Request(rid=100 + i, prompt=prefix + [11 + i] * 8, max_new=4)
               for i in range(3)]
    for r in readers:
        eng.submit(r)
    eng.try_admit()
    shared = [p for p in range(eng.n_pages)
              if eng.sched.alloc.refcount[p] == len(readers)]
    require(len(shared) == PAGED_PREFIX // ps and shared[0] in eng.wire,
            f"paged: shared pages {shared}")
    repaired0 = eng.wire.stats["repaired"]
    eng.corrupt_wire(shared[0], channel=1, delta=3)
    detected = not eng.wire_ok(shared[0])
    report = eng.repair_wire(shared[0])
    eng.run_to_completion()
    live = {"shared_pages": shared, "detected": detected, "repair": report,
            "readers_verified": [eng.verify_log[r.rid] for r in readers],
            "repairs": eng.wire.stats["repaired"] - repaired0}
    require(detected and report == {"repaired": 1, "unrecoverable": 0}
            and all(live["readers_verified"]) and live["repairs"] == 1,
            f"paged: live shared-page fault {live}")
    paged_done = {r.rid: r for r in eng.sched.completed}
    paged_rows = dict(probe.rows)
    paged_times = step_times(probe)
    a_launches, a_seconds = a["launches"], a["seconds"]
    del eng, probe, a, fp

    # (b) the same trace on the batched cache
    b = serve_run(PAGED_ENGINE + PAGED_MONO + ("--trace", path),
                  keep_rows=PAGED_ROW_RIDS)
    mono_done = {r.rid: r for r in b["engine"].sched.completed}
    same_tokens = all(paged_done[k].out == mono_done[k].out
                      for k in range(n_req))
    require(same_tokens, "paged: tokens differ from the batched cache's")
    rows_equal = {}
    for rid in PAGED_ROW_RIDS:
        pk, pv = paged_rows[rid]
        mk, mv = b["probe"].rows[rid]
        rows_equal[rid] = (pk.shape == mk.shape and torch.equal(pk, mk)
                           and torch.equal(pv, mv))
    require(all(rows_equal.values()),
            f"paged: logical K/V rows against the batched rows {rows_equal}")
    mono_times = step_times(b["probe"])
    b_seconds, b_wall = b["seconds"], b["report"]["wall_s"]
    del b

    # (c) offline, pow2 buckets, on the trace
    c = serve_run(PAGED_ENGINE + PAGED_OFFLINE + ("--trace", path),
                  keep_rows=PAGED_ROW_RIDS, keep_logits=range(n_req))
    crep, harness, cprobe = c["report"], c["engine"], c["probe"]
    require(crep["retrace_free"] and harness.steady_state_ok(),
            f"paged offline: census {crep['jit_traces']} against warmup "
            f"{crep['warmup']['jit_traces']}")
    require(crep["requests"] == n_req and crep["tokens_out"] == tokens,
            f"paged offline: {crep['requests']} requests")
    require(crep["rns"] == {"slots_verified": n_req, "slots_failed": 0},
            f"paged offline: rns {crep['rns']}")
    off_done = {r.rid: r for r, _ in harness.completions}
    differ = [k for k in range(n_req) if off_done[k].out != paged_done[k].out]
    # bucketed prefill's logical K/V rows against the chunk loop's (a):
    # measured, not required (bucketed widths sum in other orders)
    bucketed_rows = {}
    for rid in PAGED_ROW_RIDS:
        pairs = list(zip(cprobe.rows[rid], paged_rows[rid]))
        bucketed_rows[str(rid)] = {
            "bitwise": all(x.shape == y.shape and torch.equal(x, y)
                           for x, y in pairs),
            "max_abs_diff": max(float((x.float() - y.float()).abs().max())
                                for x, y in pairs)}
    held = (differ or [7, 16])[:2]
    cfg, params = harness.engines[0].cfg, harness.engines[0].params
    consistency = [teacher_forced(cfg, params, off_done[k],
                                  cprobe.logits_of(k), dev) for k in held]
    offline = {
        "seconds": c["seconds"], "wall_s": crep["wall_s"],
        "tok_per_s": crep["tok_per_s"], "ttft_s": crep["ttft_s"],
        "latency_s": crep["latency_s"], "buckets": crep["buckets"],
        "paging": crep["paging"], "overlap": crep["overlap"],
        "engine_steps": crep["engine_steps"], "warmup": crep["warmup"],
        "jit_traces": crep["jit_traces"], "rns": crep["rns"],
        "tokens_equal_sim": not differ, "tokens_differ_rids": differ,
        "kv_rows_vs_sim": bucketed_rows,
        "teacher_forced": consistency, "launches": c["launches"],
        **step_times(cprobe)}
    del c, harness, cprobe, params

    # (d) the mixed families offline
    mixed_args = SERVE_MIXED_ARGS + PAGED_MIXED
    d = serve_run(mixed_args)
    drep = d["report"]
    n_crypto = int(SERVE_MIXED_ARGS[
        SERVE_MIXED_ARGS.index("--crypto-requests") + 1])
    require(drep["crypto"]["oracle_ok"] == n_crypto
            and drep["crypto"]["oracle_failed"] == 0,
            f"paged mixed: crypto {drep['crypto']}")
    require(drep["retrace_free"] and drep["rns"]["slots_failed"] == 0
            and drep["rns"]["slots_verified"] == drep["requests"],
            f"paged mixed: {drep['rns']}, census {drep['jit_traces']}")
    mixed = {"args": list(mixed_args), "seconds": d["seconds"],
             "wall_s": drep["wall_s"], "requests": drep["requests"],
             "crypto": drep["crypto"], "rns": drep["rns"],
             "jit_traces": drep["jit_traces"], "launches": d["launches"]}
    del d

    # (e) loadgen
    e = serve_run(PAGED_LOADGEN)
    erep = e["report"]
    require(all(ph["retrace_free"] for ph in erep["phases"])
            and e["engine"].steady_state_ok(),
            "paged loadgen: a phase met a new signature")
    loadgen = {"args": list(PAGED_LOADGEN), "seconds": e["seconds"],
               **{k: erep[k] for k in ("slo", "phases", "bracket", "note",
                                       "slo_pass", "max_qps",
                                       "sustained_qps")},
               "attestation": erep.get("attestation"),
               "launches": e["launches"]}
    del e

    total = Counter(a_launches)
    for run in (offline, mixed, loadgen):
        total.update(run["launches"])
    return {
        "sim": {"args": list(PAGED_ENGINE + PAGED_SIM), "seconds": a_seconds,
                "wall_s": rep["wall_s"], "tok_per_s": rep["tok_per_s"],
                "steps": rep["steps"], "ttft_ticks": rep["ttft_ticks"],
                "latency_ticks": rep["latency_ticks"], "paging": pg,
                "rns": rns, "jit_traces": rep["jit_traces"],
                "pages_mapped_peak": mapped, "pages_in_use_peak": in_use,
                "reader_prompt_pages": reader_pages,
                "codewords_put": puts,
                "live_shared_fault": live, "page_fingerprint_ms": page_fp_ms,
                "launches": a_launches, **paged_times},
        "batched": {"args": list(PAGED_ENGINE + PAGED_MONO),
                    "seconds": b_seconds, "wall_s": b_wall,
                    "tokens_equal": same_tokens,
                    "kv_rows_bitwise": {str(k): v
                                        for k, v in rows_equal.items()},
                    **mono_times},
        "offline": offline, "mixed": mixed, "loadgen": loadgen,
        "launches": implied(**total)}


# ------------------------------- slice 12: offline replicas over ranks
def replica_rank(rank: int, out_dir: str) -> int:
    """One rank of phase 6h, started by ``replicas_main_path`` with
    torchrun's environment: loads the kernels the parent built, drives
    ``launch.serve.main(REPLICA_ARGS)`` (which makes the gloo world from
    that environment and takes the card) with the launch counts set to 0
    just before and read just after, and writes its result to
    ``out_dir/rank<r>.json``: its launches, peak device memory, census,
    its own exchange times, and on rank 0 the report and every request's
    tokens.  It prints nothing of its own; its output goes to a log."""
    import torch

    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve.offline import sample_stats

    build.load()
    ops.reset_launches()
    t0 = time.perf_counter()
    report, harness = launch_serve.main(list(REPLICA_ARGS))
    seconds = time.perf_counter() - t0
    launches = launch_counts(ops)
    harness.require_steady_state()
    rs = harness.replica_set
    ms = rs.exchange_ms          # this process's one run
    out = {"rank": rank, "seconds": seconds, "launches": launches,
           "replica": rs.replica, "steady_state": harness.steady_state_ok(),
           "device": str(harness.devices[0]),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "exchange_ms": sample_stats(ms), "report": report,
           "tokens": {str(r.rid): list(r.out)
                      for r, _ in harness.completions}}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def replicas_main_path(dev) -> dict:
    """Phase 6h: REPLICA_ARGS through the serve CLI in REPLICA_WORLD
    processes on the one card (``replica_rank``, torchrun's environment on
    a free local port), two replicas of one rank behind the controller on
    rank 0; a process that fails, or outlasts REPLICA_TIMEOUT, fails the
    phase.  Then the same arguments in this process, the one-process
    ``OfflineInference(replicas=2)`` on the card.  Required: every request
    served once, every fingerprint verified, the census unchanged on every
    rank, rank 0's tokens for every rid and ``dispatched`` equal to the
    one-process run's.  Measured: wall s and tokens/s of both, each rank's
    exchange ms a tick, each process's peak device memory."""
    import socket

    out_dir = os.path.join(ROOT, "chiprun_out", "replicas")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(REPLICA_WORLD),
               LOCAL_WORLD_SIZE=str(REPLICA_WORLD))
    t0 = time.perf_counter()
    procs, logs = [], []
    for r in range(REPLICA_WORLD):
        logs.append(open(os.path.join(out_dir, f"rank{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--replica-rank",
             str(r), out_dir], cwd=ROOT, stdout=logs[-1],
            stderr=subprocess.STDOUT,
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r))))
    try:
        deadline = time.monotonic() + REPLICA_TIMEOUT
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(1.0,
                                              deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                rcs.append("timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    ranks_seconds = time.perf_counter() - t0
    for r, rc in enumerate(rcs):
        if rc != 0:
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                tail = f.read()[-3000:]
            require(False, f"replicas: rank {r} ended with {rc}:\n{tail}")
    res = []
    for r in range(REPLICA_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            res.append(json.load(f))
    rep = res[0]["report"]
    n_req = int(REPLICA_ARGS[REPLICA_ARGS.index("--requests") + 1])
    max_new = int(REPLICA_ARGS[REPLICA_ARGS.index("--max-new") + 1])
    require(rep["requests"] == n_req and rep["tokens_out"] == n_req * max_new
            and len(res[0]["tokens"]) == n_req,
            f"replicas: {rep['requests']} requests, {rep['tokens_out']} "
            f"tokens")
    require(rep["rns"] == {"slots_verified": n_req, "slots_failed": 0},
            f"replicas: rns {rep['rns']}")
    require(rep["retrace_free"] and all(x["steady_state"] for x in res),
            f"replicas: census {rep['jit_traces']} against warmup "
            f"{rep['warmup']['jit_traces']}")
    require(rep["n_chips"] == REPLICA_WORLD and rep["replicas"] == 2
            and [x["replica"] for x in res] == list(range(REPLICA_WORLD)),
            f"replicas: {rep['n_chips']} chips, replicas "
            f"{[x['replica'] for x in res]}")

    # the one-process harness: two replicas on this card, the same workload
    one = serve_run(REPLICA_ARGS)
    orep, harness = one["report"], one["engine"]
    want = {str(r.rid): list(r.out) for r, _ in harness.completions}
    differ = sorted(k for k in want if res[0]["tokens"].get(k) != want[k])
    require(not differ and len(want) == n_req,
            f"replicas: rids {differ} differ from the one-process run's")
    require(rep["dispatched"] == orep["dispatched"],
            f"replicas: dispatched {rep['dispatched']} against "
            f"{orep['dispatched']} in one process")
    require(orep["retrace_free"] and orep["rns"]["slots_failed"] == 0,
            f"replicas: one-process run {orep['rns']}")
    del harness, one["engine"]
    launches = Counter()
    for x in res:
        launches.update(x["launches"])
    return {
        "args": list(REPLICA_ARGS), "world": REPLICA_WORLD,
        "seconds": time.perf_counter() - t0, "ranks_seconds": ranks_seconds,
        "wall_s": rep["wall_s"], "tok_per_s": rep["tok_per_s"],
        "engine_steps": rep["engine_steps"], "dispatched": rep["dispatched"],
        "ttft_s": rep["ttft_s"], "latency_s": rep["latency_s"],
        "buckets": rep["buckets"], "control": rep["control"],
        "exchange_ms_by_rank": [x["exchange_ms"] for x in res],
        "max_memory_allocated_by_rank": [x["max_memory_allocated"]
                                         for x in res],
        "rank_seconds": [x["seconds"] for x in res],
        "devices": [x["device"] for x in res],
        "rns": rep["rns"], "jit_traces": rep["jit_traces"],
        "tokens_equal_one_process": not differ,
        "one_process": {"seconds": one["seconds"], "wall_s": orep["wall_s"],
                        "tok_per_s": orep["tok_per_s"],
                        "engine_steps": orep["engine_steps"],
                        "dispatched": orep["dispatched"],
                        "n_chips": orep["n_chips"],
                        "peak_memory_of_run": one["peak_memory_of_run"],
                        "launches": one["launches"]},
        "launches": implied(**launches)}


# ------------------------------------------- slice 7: the moe and vlm families
def warm_main_path(dev) -> dict:
    """Phase 6g: warm restart of gemma3-1b's paged engine at full width
    (PAGED_ENGINE, pages of 512, ``--rns-verify``) on WARM_SHARED
    requests behind the 1,024-token prefix, WARM_MAX_NEW new tokens each.
    The cold run with ``--warm-restart`` persists its retained pages (at
    least the prefix's two); one RRNS channel of leaf 0 of that state is
    corrupted; the identical second run must restore it with the channel
    repaired, adopt every saved page (each revalidated against a codeword
    recomputed by the codec_encode kernel), drop none, dedup against them
    and give the cold run's tokens bit for bit.  The pool is reckoned
    beside the bytes written."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve import batcher
    from repro_torch.train import checkpointer as ckpt

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "warm_trace.jsonl")
    trace = paged_trace(path, PAGED_ENGINE, shared=WARM_SHARED, bare=0,
                        max_new=WARM_MAX_NEW)
    argv = PAGED_ENGINE + WARM_ARGS + ("--warm-restart", WARM_DIR,
                                       "--trace", path)
    B = batcher.ContinuousBatcher
    orig = {n: getattr(B, n) for n in ("save_warm_state", "load_warm_state",
                                       "drain_completed")}
    calls, drained = [], []

    def drain(eng):
        # the CLI drains the retired requests before it persists the pool
        done = orig["drain_completed"](eng)
        drained.extend(done)
        return done

    def timed(name):
        def call(eng, state_dir):
            torch.cuda.synchronize()
            before, t0 = launch_counts(ops), time.perf_counter()
            try:
                return orig[name](eng, state_dir)
            finally:
                torch.cuda.synchronize()
                after = launch_counts(ops)
                calls.append({"call": name,
                              "seconds": time.perf_counter() - t0,
                              "launches": {k: after[k] - before[k]
                                           for k in after}})
        return call

    shutil.rmtree(WARM_DIR, ignore_errors=True)
    t_start = time.perf_counter()
    runs = {}
    try:
        for name in ("save_warm_state", "load_warm_state"):
            setattr(B, name, timed(name))
        B.drain_completed = drain
        for label in ("cold", "warm"):
            if label == "warm":
                ckpt.inject_channel_corruption(
                    os.path.join(WARM_DIR, "step_0"), leaf=0, channels=(2,))
            r = serve_run(argv)
            eng = r.pop("engine")
            r["tokens"] = {q.rid: list(q.out) for q in drained}
            drained.clear()
            r["pool_bytes"] = sum(eng.cache[n].numel()
                                  * eng.cache[n].element_size()
                                  for n in ("k", "v"))
            r["n_pages"] = eng.n_pages
            r["state_bytes"] = dir_bytes(WARM_DIR)
            r["calls"], calls[:] = list(calls), []
            del eng, r["probe"]
            free_card()
            runs[label] = r
    finally:
        for name, fn in orig.items():
            setattr(B, name, fn)
        shutil.rmtree(WARM_DIR, ignore_errors=True)
    cold, warm = runs["cold"], runs["warm"]
    cw, ww = cold["report"]["warm_restart"], warm["report"]["warm_restart"]
    require(cw["restored"] is False and cw["pages_saved"] >= 2,
            f"warm: cold run {cw}")
    require(ww["restored"] is True and ww["ckpt_repaired_leaves"] == 1
            and ww["adopted"] == cw["pages_saved"] and ww["dropped"] == 0,
            f"warm: second run {ww}")
    pg, rns = warm["report"]["paging"], warm["report"]["rns"]
    require(pg["dedup_hits"] >= 1 and rns["slots_failed"] == 0
            and cold["report"]["rns"]["slots_failed"] == 0,
            f"warm: paging {pg}, rns {rns}")
    require(warm["tokens"] == cold["tokens"]
            and len(warm["tokens"]) == len(trace),
            "warm: the second run's tokens differ from the cold run's")
    load = next(c for c in warm["calls"] if c["call"] == "load_warm_state")
    require(load["launches"] == implied(codec_encode=ww["adopted"]),
            f"warm: revalidation launches {load['launches']}")
    pool = cold["pool_bytes"]
    return {
        "seconds": time.perf_counter() - t_start,
        "requests": len(trace), "max_new": WARM_MAX_NEW,
        "cold": {"warm_restart": cw, "seconds": cold["seconds"],
                 "dedup_hits": cold["report"]["paging"]["dedup_hits"],
                 "calls": cold["calls"], "launches": cold["launches"]},
        "warm": {"warm_restart": ww, "seconds": warm["seconds"],
                 "dedup_hits": pg["dedup_hits"], "calls": warm["calls"],
                 "launches": warm["launches"]},
        "pool_reckoned": {"n_pages": cold["n_pages"],
                          "page_size": int(WARM_ARGS[1]),
                          "pool_bytes": pool,
                          "wire_bytes": CKPT_CHANNELS * pool},
        "state_bytes_written": cold["state_bytes"],
        "revalidation_encode_launches": load["launches"]["codec_encode"],
        "tokens_equal": True,
        "launches": implied(**(Counter(cold["launches"])
                               + Counter(warm["launches"]))),
    }


def moe_train_path(dev, max_err) -> dict:
    """Phase 5c: qwen2-moe-a2.7b at full width cut to MOE_TRAIN_LAYERS
    layers through the training CLI (MOE_TRAIN_ARGS), the fp32 run and
    the ``--rns-allreduce`` run from one seed: finite losses, the aux loss
    of every step reported and positive, one encode and one decode launch a
    codec step, step TRAIN_CHECK_STEP's encode and decode against their
    plain versions bit for bit, and the codec's loss drift against fp32
    under TRAIN_MAX_DRIFT a step."""
    runs, launches = {}, Counter()
    t0 = time.perf_counter()
    for label, flags, check in (("fp32", (), None),
                                ("rns", ("--rns-allreduce",),
                                 TRAIN_CHECK_STEP)):
        r = train_run(dev, max_err, label, flags, check, args=MOE_TRAIN_ARGS,
                      layers=MOE_TRAIN_LAYERS, phase="moe_train")
        s = r["summary"]
        require(all(math.isfinite(a) and a > 0 for a in s["auxes"]),
                f"moe train {label}: aux {s['auxes']}")
        launches.update(r["launches"])
        emit({"phase": "moe_train", "run": label, "seconds": r["seconds"],
              "layers": MOE_TRAIN_LAYERS, "elements": r["elements"],
              "losses": s["losses"], "auxes": s["auxes"],
              "step_ms_median": statistics.median(s["step_ms"]),
              "tokens_per_s_median": statistics.median(s["tokens_per_s"]),
              "max_memory_allocated": s["max_memory_allocated"],
              "reckoned_bytes": r["reckoned_bytes"],
              "launches": r["launches"], "checked": r["checked"]})
        runs[label] = s
        del r
    drift = max(abs(a - b) for a, b in zip(runs["rns"]["losses"],
                                           runs["fp32"]["losses"]))
    require(drift <= TRAIN_MAX_DRIFT, f"moe train: RNS loss drift {drift}")
    return {"launches": implied(**launches), "drift": drift,
            "seconds": time.perf_counter() - t0}


def check_engine_report(rep, n_req, tokens, what) -> None:
    """A sim run's counts, census and fingerprints; its injected wire fault
    detected, repaired once and re-verified."""
    require(rep["requests"] == n_req and rep["tokens_out"] == tokens,
            f"{what}: {rep['requests']} requests, {rep['tokens_out']} "
            f"tokens")
    require(set(rep["jit_traces"].values()) == {1},
            f"{what}: jit_traces {rep['jit_traces']}")
    rns = rep["rns"]
    require(rns["slots_verified"] == n_req and rns["slots_failed"] == 0,
            f"{what}: rns {rns}")
    if "injected_repair" in rns:
        require(rns["injected_detected"] and rns["injected_reverified"]
                and rns["injected_repair"] == {"repaired": 1,
                                               "unrecoverable": 0},
                f"{what}: injected wire fault {rns}")


def moe_serve_path(dev, max_err) -> dict:
    """Phase 6d: qwen2-moe-a2.7b at full width and depth.  (a) The serve
    CLI on phase 6b's engine shape and workload (MOE_SERVE_ARGS): every
    request served and fingerprint verified, the injected fault repaired,
    one encode launch per admission and per retirement, the kernel on a
    real fingerprint against its plain version; rids SERVE_SOLO_RIDS alone
    on a fresh engine equal to the packed run bit for bit (tokens, K/V
    rows).  (b) The no-drop runs: the engine API on the same parameters at
    ``capacity_factor = E / K``, every call's capacity checked to hold its
    tokens, SERVE_CHECK_RIDS' logits against a teacher-forced forward; in
    the config's bf16 measured (routing flips: a token whose 4th and 5th
    experts sit within bf16's rounding of each other takes another expert
    when the chunked prefill and the one-pass forward round differently,
    ``tools/moe_routing.py``), in f32 compute held to SERVE_LOGIT_TOL.
    (c) Phase 6c's shared-prefix trace on the paged pool and on the
    batched cache: tokens and rids PAGED_ROW_RIDS' logical K/V rows equal
    bit for bit.  (d) ``--mode offline --buckets pow2`` on the trace: the
    census equal to warmup's, the tokens that differ from (c)'s chunk
    loop counted (bucketed chunks change the capacity)."""
    import torch

    from repro_torch.kernels.codec_encode import (codec_encode_kernel_call,
                                                  codec_encode_plain)
    from repro_torch.models.moe import capacity
    from repro_torch.serve.batcher import ContinuousBatcher
    from repro_torch.serve.scheduler import Request

    t_start = time.perf_counter()
    free_card()
    at_start = torch.cuda.memory_allocated()
    # (a) the CLI, batched cache
    run = serve_run(MOE_SERVE_ARGS, keep_rows=SERVE_SOLO_RIDS)
    rep, eng, probe = run["report"], run["engine"], run["probe"]
    n_req = int(MOE_SERVE_ARGS[MOE_SERVE_ARGS.index("--requests") + 1])
    max_new = int(MOE_SERVE_ARGS[MOE_SERVE_ARGS.index("--max-new") + 1])
    check_engine_report(rep, n_req, n_req * max_new, "moe serve")
    require(run["launches"]["codec_encode"] == 2 * n_req,
            f"moe serve: launches {run['launches']}")
    last = eng.sched.completed[-1]
    fp = eng._fp_fn(eng.cache, last.slot_index, len(last.prompt))
    enc, enc_kw, _, _ = codec_tables(eng.codec)
    got = codec_encode_kernel_call(fp, *enc, **enc_kw)
    want = codec_encode_plain(fp, *enc, **enc_kw)
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    max_err["codec_encode"] = max(max_err["codec_encode"], err)
    require(err == 0 and torch.equal(got, want),
            "moe serve: codec_encode on a fingerprint differs from its plain "
            "version")
    done = {r.rid: r for r in eng.sched.completed}
    cfg, params = eng.cfg, eng.params
    shape = dict(n_slots=eng.sched.n_slots, cache_len=eng.sched.cache_len,
                 prefill_chunk=eng.prefill_chunk)
    main_run = {"args": list(MOE_SERVE_ARGS), "seconds": run["seconds"],
                "wall_s": rep["wall_s"], "tok_per_s": rep["tok_per_s"],
                "steps": rep["steps"], "ttft_ticks": rep["ttft_ticks"],
                "rns": rep["rns"], "jit_traces": rep["jit_traces"],
                "launches": run["launches"], **step_times(probe),
                **{k: run[k] for k in ("memory_allocated_at_start",
                                       "max_memory_allocated",
                                       "peak_memory_of_run")}}
    solo_rows = probe.rows
    del eng, probe, run, fp

    solo = ContinuousBatcher(cfg, params, rns_verify=True, **shape)
    invariance = []
    for rid in SERVE_SOLO_RIDS:
        r = done[rid]
        alone = Request(rid=rid, prompt=list(r.prompt), max_new=r.max_new)
        solo.submit(alone)
        solo.run_to_completion()
        end = len(r.prompt) + len(r.out) - 1
        same_tokens = alone.out == r.out
        same_rows = all(torch.equal(solo.cache[n][:, alone.slot_index, :end],
                                    b)
                        for n, b in zip(("k", "v"), solo_rows[rid]))
        require(same_tokens and same_rows and solo.verify_log[rid],
                f"moe serve: rid {rid} alone: tokens {same_tokens}, K/V "
                f"rows {same_rows}")
        invariance.append({"rid": rid, "plen": len(r.prompt),
                           "slot_mixed": r.slot_index, "tokens_equal": True,
                           "kv_rows_bitwise": True})
    del solo, solo_rows

    # (b) no token can drop: the teacher-forced bound, held in f32
    nodrop = dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    lengths = {1, shape["prefill_chunk"]} | {
        -(-(len(done[k].prompt) + len(done[k].out) - 1) // ATTN_CHUNK)
        * ATTN_CHUNK for k in SERVE_CHECK_RIDS}     # as teacher_forced pads
    require(all(capacity(nodrop, s) >= s for s in lengths),
            f"moe no-drop: capacity below a call's length in {lengths}")
    consistency = {}
    for dtype in dict.fromkeys((cfg.dtype, "float32")):
        run_cfg = dataclasses.replace(nodrop, dtype=dtype)
        eng = ContinuousBatcher(run_cfg, params, **shape)
        reqs = [Request(rid=k, prompt=list(done[k].prompt),
                        max_new=done[k].max_new) for k in SERVE_CHECK_RIDS]
        with ServeProbe(keep_logits=SERVE_CHECK_RIDS) as nd_probe:
            for r in reqs:
                eng.submit(r)
            eng.run_to_completion()
        consistency[dtype] = [
            teacher_forced(run_cfg, params, r, nd_probe.logits_of(r.rid), dev,
                           held=dtype == "float32") for r in reqs]
        if dtype == cfg.dtype:     # the same tokens as at factor 1.25?
            for c, r in zip(consistency[dtype], reqs):
                c["tokens_differ_from_factor_1_25"] = sum(
                    a != b for a, b in zip(r.out, done[r.rid].out))
        del eng, nd_probe
        free_card()
    del params

    # (c) the shared-prefix trace, paged pool against batched cache
    free_card()
    path = os.path.join(ROOT, "chiprun_out", "moe_paged_trace.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    trace = paged_trace(path, MOE_ENGINE)
    n_tr = len(trace)
    a = serve_run(MOE_ENGINE + PAGED_SIM + ("--trace", path),
                  keep_rows=PAGED_ROW_RIDS)
    check_engine_report(a["report"], n_tr, n_tr * PAGED_MAX_NEW, "moe paged")
    paged_done = {r.rid: r for r in a["engine"].sched.completed}
    paged_rows, paged_times = dict(a["probe"].rows), step_times(a["probe"])
    paged = {"seconds": a["seconds"], "wall_s": a["report"]["wall_s"],
             "tok_per_s": a["report"]["tok_per_s"],
             "paging": a["report"]["paging"], "launches": a["launches"],
             **paged_times}
    del a
    free_card()
    b = serve_run(MOE_ENGINE + PAGED_MONO + ("--trace", path),
                  keep_rows=PAGED_ROW_RIDS)
    check_engine_report(b["report"], n_tr, n_tr * PAGED_MAX_NEW,
                        "moe batched")
    mono_done = {r.rid: r for r in b["engine"].sched.completed}
    same_tokens = all(paged_done[k].out == mono_done[k].out
                      for k in range(n_tr))
    rows_equal = {str(rid): all(x.shape == y.shape and torch.equal(x, y)
                                for x, y in zip(paged_rows[rid],
                                                b["probe"].rows[rid]))
                  for rid in PAGED_ROW_RIDS}
    require(same_tokens and all(rows_equal.values()),
            f"moe paged against batched: tokens {same_tokens}, rows "
            f"{rows_equal}")
    batched = {"seconds": b["seconds"], "wall_s": b["report"]["wall_s"],
               "tok_per_s": b["report"]["tok_per_s"],
               "tokens_equal": same_tokens, "kv_rows_bitwise": rows_equal,
               "launches": b["launches"], **step_times(b["probe"])}
    del b, paged_rows

    # (d) offline, pow2 buckets
    free_card()
    c = serve_run(MOE_ENGINE + PAGED_OFFLINE + ("--trace", path))
    crep, harness = c["report"], c["engine"]
    require(crep["retrace_free"] and harness.steady_state_ok(),
            f"moe offline: census {crep['jit_traces']} against warmup "
            f"{crep['warmup']['jit_traces']}")
    require(crep["requests"] == n_tr
            and crep["rns"] == {"slots_verified": n_tr, "slots_failed": 0},
            f"moe offline: {crep['requests']} requests, rns {crep['rns']}")
    off_done = {r.rid: r for r, _ in harness.completions}
    offline = {"seconds": c["seconds"], "wall_s": crep["wall_s"],
               "tok_per_s": crep["tok_per_s"], "ttft_s": crep["ttft_s"],
               "latency_s": crep["latency_s"], "buckets": crep["buckets"],
               "jit_traces": crep["jit_traces"],
               "warmup_jit_traces": crep["warmup"]["jit_traces"],
               "requests_differing_from_chunk_loop": sum(
                   off_done[k].out != paged_done[k].out for k in range(n_tr)),
               "tokens_differing_from_chunk_loop": sum(
                   x != y for k in range(n_tr)
                   for x, y in zip(off_done[k].out, paged_done[k].out)),
               "launches": c["launches"]}
    del c, harness
    free_card()
    total = Counter()
    for part in (main_run, paged, batched, offline):
        total.update(part["launches"])
    return {"main": dict(main_run, invariance=invariance),
            "no_drop": {"capacity_factor": nodrop.capacity_factor,
                        "lengths": sorted(lengths),
                        "teacher_forced": consistency},
            "paged": paged, "batched": batched, "offline": offline,
            "launches": implied(**total), "memory_allocated_at_start":
            at_start, "seconds": time.perf_counter() - t_start}


def single_shot_run(argv, layers=None, **fields):
    """One serve CLI run on an arch the engine gates out, so single-shot
    (``serve_run``; the configs cut to ``layers`` layers and ``fields``
    replaced when given).  Each request's config, parameters, prompt, stub
    inputs (patches, frames) and logit rows (the prefill's, then each
    decode step's) are recorded, and each decode step is timed by CUDA
    events.  Returns (the run, the requests' records)."""
    import torch

    from repro_torch.launch import serve as launch_serve

    seen = []
    orig = {"prefill": launch_serve.prefill,
            "decode_step": launch_serve.decode_step}

    def prefill(cfg, params, batch, cache_len):
        logits, cache = orig["prefill"](cfg, params, batch, cache_len)
        seen.append({"cfg": cfg, "params": params,
                     "prompt": batch["tokens"][0].tolist(),
                     "stubs": {k: v for k, v in batch.items()
                               if k != "tokens"},
                     "logits": [logits[0]], "events": []})
        return logits, cache

    def decode_step(cfg, params, cache, tokens, pos):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        logits, cache = orig["decode_step"](cfg, params, cache, tokens, pos)
        e1.record()
        seen[-1]["logits"].append(logits[0])
        seen[-1]["events"].append((e0, e1))
        return logits, cache

    launch_serve.prefill, launch_serve.decode_step = prefill, decode_step
    try:
        with replaced_config(launch_serve, **fields), \
                cut_depth(launch_serve, layers):
            run = serve_run(argv)
    finally:
        launch_serve.prefill = orig["prefill"]
        launch_serve.decode_step = orig["decode_step"]
    torch.cuda.synchronize()
    for rec in seen:
        rec["decode_ms"] = [a.elapsed_time(b) for a, b in rec["events"]]
    return run, seen


def check_single_shot(run, seen, n_req, max_new, what) -> None:
    """The report of a single-shot run: one slot, every request served
    with all its ``max_new`` tokens (no EOS in these workloads)."""
    rep = run["report"]
    require(rep["engine"] == "single-shot" and run["engine"] is None
            and rep["n_slots"] == 1 and rep["requests"] == n_req
            and rep["tokens_out"] == n_req * max_new and len(seen) == n_req
            and all(len(s["logits"]) == max_new for s in seen),
            f"{what}: report {rep}")


def held_to_forward(seen, dev, held=True) -> list:
    """Each recorded request's logits against its teacher-forced forward
    (``teacher_forced``); the tokens the CLI chose are each row's
    argmax."""
    import torch

    checked = []
    for i, s in enumerate(seen):
        logits = torch.stack(s["logits"])
        r = types.SimpleNamespace(rid=i, prompt=s["prompt"],
                                  out=logits.argmax(dim=-1).tolist())
        checked.append(teacher_forced(s["cfg"], s["params"], r, logits, dev,
                                      stubs=s["stubs"], held=held))
    return checked


def vlm_single_shot_path(dev) -> dict:
    """Phase 6e: internvl2-26b at full width cut to VLM_LAYERS layers
    through the serve CLI (VLM_ARGS) on a trace of VLM_PROMPTS it writes,
    which gates the vlm family out of the engine and falls back to
    single-shot serving; each request's logits (the last prompt position,
    then each decode step) against a teacher-forced forward with the same
    patches."""
    from repro_torch.configs import get_config

    t_start = time.perf_counter()
    free_card()
    chunk_trace(VLM_ARGS[VLM_ARGS.index("--trace") + 1],
                get_config(VLM_ARCH).vocab, VLM_PROMPTS, VLM_MAX_NEW)
    run, seen = single_shot_run(VLM_ARGS, VLM_LAYERS)
    rep = run["report"]
    check_single_shot(run, seen, len(VLM_PROMPTS), VLM_MAX_NEW, "vlm")
    cfg, params = seen[0]["cfg"], seen[0]["params"]
    checked = held_to_forward(seen, dev)
    return {"args": list(VLM_ARGS), "layers": cfg.n_layers,
            "parameters": sum(p.numel() for _, p in _named(params)),
            "seconds": run["seconds"], "wall_s": rep["wall_s"],
            "tok_per_s": rep["tok_per_s"], "steps": rep["steps"],
            "patches": cfg.n_patches, "teacher_forced": checked,
            "max_memory_allocated": run["max_memory_allocated"],
            "phase_seconds": time.perf_counter() - t_start}


# ------------------------------ slice 8: the ssm, hybrid and encdec families
def family_train_path(dev, max_err) -> dict:
    """Phase 5d: mamba2-370m, zamba2-1.2b and whisper-tiny at full width and
    depth through the training CLI (FAMILY_TRAIN_ARGS), each the fp32 run
    and the ``--rns-allreduce`` run from one seed: finite losses, one
    encode and one decode launch a codec step, step TRAIN_CHECK_STEP's
    encode and decode against their plain versions bit for bit, the codec's
    loss drift against fp32 under TRAIN_MAX_DRIFT a step.  Then the
    README's ``--rns-correct --inject-corrupt-step 2`` on mamba2: one value
    repaired, nothing unrepairable, the parameters after the last step
    those of the run without the fault bit for bit."""
    t0 = time.perf_counter()
    runs, launches, out = {}, Counter(), {}

    def run(arch, label, flags=(), check=None, keep=False):
        r = train_run(dev, max_err, f"{arch}/{label}", flags, check,
                      args=FAMILY_TRAIN_ARGS[arch], phase="family_train")
        s = r["summary"]
        launches.update(r["launches"])
        emit({"phase": "family_train", "arch": arch, "run": label,
              "seconds": r["seconds"], "elements": r["elements"],
              "losses": s["losses"], "step_ms": s["step_ms"],
              "tokens_per_s": s["tokens_per_s"],
              "step_ms_median": statistics.median(s["step_ms"]),
              "tokens_per_s_median": statistics.median(s["tokens_per_s"]),
              "max_memory_allocated": s["max_memory_allocated"],
              "reckoned_bytes": r["reckoned_bytes"],
              "launches": r["launches"], "checked": r["checked"]})
        runs[arch, label] = s
        return r["params"] if keep else None

    for arch in FAMILY_TRAIN_ARGS:
        run(arch, "fp32")
        run(arch, "rns", ("--rns-allreduce",), TRAIN_CHECK_STEP)
        drift = max(abs(a - b) for a, b in zip(runs[arch, "rns"]["losses"],
                                               runs[arch, "fp32"]["losses"]))
        require(drift < TRAIN_MAX_DRIFT, f"{arch} train: drift {drift}")
        out[arch] = {"drift": drift,
                     **{f"{k}_step_ms_median": statistics.median(
                         runs[arch, k]["step_ms"]) for k in ("fp32", "rns")},
                     **{f"{k}_tokens_per_s_median": statistics.median(
                         runs[arch, k]["tokens_per_s"])
                        for k in ("fp32", "rns")},
                     "max_memory_allocated": max(
                         runs[arch, k]["max_memory_allocated"]
                         for k in ("fp32", "rns"))}
    hit = run(SSM_ARCH, "rns_correct_injected",
              ("--rns-correct", "--inject-corrupt-step",
               str(TRAIN_INJECT_STEP)), keep=True)
    clean = run(SSM_ARCH, "rns_correct", ("--rns-correct",), keep=True)
    steps = len(runs[SSM_ARCH, "rns_correct"]["losses"])
    require(runs[SSM_ARCH, "rns_correct_injected"]["repaired"]
            == [int(i == TRAIN_INJECT_STEP) for i in range(steps)]
            and runs[SSM_ARCH, "rns_correct"]["repaired"] == [0] * steps,
            f"{SSM_ARCH} train: repaired counts")
    require(runs[SSM_ARCH, "rns_correct_injected"]["unrepairable"]
            == runs[SSM_ARCH, "rns_correct"]["unrepairable"] == [0] * steps,
            f"{SSM_ARCH} train: unrepairable counts")
    for (name, a), (_, b) in zip(_named(hit), _named(clean)):
        require(bits_equal(a, b), f"{SSM_ARCH} train: {name} after the "
                "repaired run differs from the run without the fault")
    del hit, clean
    out[SSM_ARCH]["rns_correct_repaired"] = runs[
        SSM_ARCH, "rns_correct_injected"]["repaired"]
    return {"runs": out, "launches": implied(**launches),
            "seconds": time.perf_counter() - t0}


def chunk_trace(path: str, vocab: int, lengths, max_new: int) -> None:
    """A JSONL workload (the serve CLI's ``--trace``) of whole-chunk
    prompts: one request per length of ``lengths``, seeded random tokens,
    ``max_new`` new tokens and no EOS, arriving a tick apart."""
    import numpy as np

    rng = np.random.default_rng(0)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for i, n in enumerate(lengths):
            f.write(json.dumps({
                "rid": i, "prompt": rng.integers(1, vocab, n).tolist(),
                "max_new": max_new, "eos": None,
                "arrival": float(i)}) + "\n")


def family_single_shot_path(dev) -> dict:
    """Phase 6f: mamba2-370m and zamba2-1.2b at full width and depth
    through the serve CLI on the trace ``chunk_trace`` writes to
    chiprun_out/ssm_trace.jsonl, and whisper-tiny on ENCDEC_SERVE_ARGS
    (frames drawn per request); the CLI gates each family out of the engine
    and serves single-shot.  Every request served; each request's logits
    (the last prompt position, then each decode step) against a
    teacher-forced forward over its prompt and tokens (and frames), padded
    at the end to a multiple of ATTN_CHUNK.  The bound is held in the
    configs' bf16 compute; where a request breaks it there, the same run in
    f32 compute is held to it instead and the bf16 distances are
    reported."""
    import statistics as st

    from repro_torch.configs import get_config

    t_start = time.perf_counter()
    path = os.path.join(ROOT, "chiprun_out", "ssm_trace.jsonl")
    out = {}
    for arch in (SSM_ARCH, HYBRID_ARCH, ENCDEC_ARCH):
        free_card()
        if arch == ENCDEC_ARCH:
            argv, n_req = ENCDEC_SERVE_ARGS, 4
        else:
            chunk_trace(path, get_config(arch).vocab, SSM_PROMPTS,
                        SSM_MAX_NEW)
            argv = ("--arch", arch, "--no-smoke", "--trace", path,
                    "--cache-len", str(max(SSM_PROMPTS) + SSM_MAX_NEW),
                    "--seed", "0", "--device", DEVICE)
            n_req = len(SSM_PROMPTS)
        rows = {}
        for dtype in ("bfloat16", "float32"):
            fields = {} if dtype == "bfloat16" else {"dtype": "float32"}
            run, seen = single_shot_run(argv, **fields)
            check_single_shot(run, seen, n_req, SSM_MAX_NEW,
                              f"{arch} single-shot")
            checked = held_to_forward(seen, dev, held=dtype == "float32")
            rep = run["report"]
            decode_ms = [t for s in seen for t in s["decode_ms"]]
            rows[dtype] = {
                "seconds": run["seconds"], "wall_s": rep["wall_s"],
                "tok_per_s": rep["tok_per_s"], "steps": rep["steps"],
                "prompt_lens": [len(s["prompt"]) for s in seen],
                "decode_ms_median": st.median(decode_ms),
                "decode_ms_max": max(decode_ms),
                "max_memory_allocated": run["max_memory_allocated"],
                "peak_memory_of_run": run["peak_memory_of_run"],
                "teacher_forced": checked}
            within = all(c["max_abs_diff"] <= c["tolerance"]
                         and c["decided_tokens_equal"] == c["decided_tokens"]
                         for c in checked)
            del run, seen
            if within:
                break
        out[arch] = {"args": list(argv), "held_on": dtype, **rows}
        emit({"phase": "family_serve", "arch": arch, **out[arch]})
    return {"runs": out, "seconds": time.perf_counter() - t_start}


def main() -> int:
    # Phase 5c's codec step peaks at 68.6 GiB of the card's 79.2 (state,
    # wire and AdamW's per-leaf temporaries); blocks that the earlier phases
    # left split would otherwise strand several GiB of it.  Read when the
    # allocator starts, so before the first CUDA call.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    from repro_torch import quickstart
    from repro_torch.configs.paper_rns import make_paper_bases
    from repro_torch.core import Layout, RnsArray, backend, make_base, rns_to_int
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.modmul import modmul_kernel_call, modmul_plain
    from repro_torch.kernels.mrc import mrc_kernel_call, mrc_plain
    from repro_torch.dist.grad_codec import GradCodec
    from repro_torch.kernels.codec_decode import (codec_decode_kernel_call,
                                                  codec_decode_plain)
    from repro_torch.kernels.codec_encode import (codec_encode_kernel_call,
                                                  codec_encode_plain)
    from repro_torch.kernels.ref import ref_compare, ref_modmul, ref_mrc
    from repro_torch.kernels.rns_compare import compare_kernel_call, compare_plain

    dev = torch.device(DEVICE, 0)
    t_start = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    sys.stdout = Tee(sys.stdout,
                     os.path.join(ROOT, "chiprun_out", "chip_smoke.out"))

    # ---------------------------------------------------------- 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    # --------------------------------------------------------- 2. build
    info = build.build()
    build.load()
    from repro_torch.kernels.mont_ladder import smem_bytes, smem_layout
    from repro_torch.serve.crypto import CryptoContext

    ctx = CryptoContext(n_limbs=CRYPTO_LIMBS, exp_bits=CRYPTO_EXP_BITS)
    shape = (ctx.n, ctx.nch_lo, ctx.n_hi)
    emit({"phase": "build", "seconds": info["seconds"], "built": info["built"],
          "library": os.path.relpath(info["path"], ROOT), "ptxas": ptxas_summary(info["ptxas"]),
          "mont_smem_bytes": {"image": smem_layout(*shape)["image"],
                              "block": {c: smem_bytes(*shape, c)
                                        for c in (8, 16)},
                              "shape": CRYPTO_SHAPE},
          "sass_opcodes": sass_opcodes(info["path"])})

    # -------------------------------------------------------- 3. parity
    gen = torch.Generator(device=dev).manual_seed(0)

    def residues(base, shape, dtype=torch.int32):
        m = base.tensor("moduli_np", dev, torch.int64)
        r = torch.randint(0, 1 << 62, (*shape, base.n), generator=gen,
                          device=dev) % m
        return r.to(dtype)

    def tiles(x):
        return x.reshape(-1, x.shape[-1]).T.to(torch.int32).contiguous()

    max_err = {"mrc": 0, "modmul": 0, "compare": 0, "codec_encode": 0,
               "codec_decode": 0.0, "mont_mul": 0, "mont_ladder": 0}

    def hold(name, got, want, where):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err[name] = max(max_err[name], err)
        require(got.shape == want.shape and err == 0,
                f"{name} kernel disagrees with its plain version at {where}")

    cases, skipped = 0, []
    for n in SWEEP_NS:
        for bits in SWEEP_BITS:
            try:
                base = make_base(n, bits=bits)
            except ValueError:          # e.g. 138 primes below 2**8 do not exist
                skipped.append({"n": n, "bits": bits})
                continue
            inv = base.tensor("inv_tri_np", dev, torch.int32)
            m = base.tensor("moduli_np", dev, torch.int32)
            betas = base.tensor("betas_ma_np", dev, torch.int32)
            image = ops._column_image(base, dev)
            for batch in SWEEP_BATCHES:
                for dtype in (torch.int32, torch.int64):
                    where = dict(n=n, bits=bits, batch=batch, dtype=str(dtype))
                    x1 = residues(base, (batch,), dtype)
                    x2 = residues(base, (batch,), dtype)
                    # mrc: wrapper (kernel) vs core plain; the kernel call
                    # on a channel-major tile and on the transposed view of
                    # channels-last rows vs the tile's plain version
                    got = ops.mrc_op(base, x1)
                    require(got.dtype == dtype, f"mrc_op dtype at {where}")
                    hold("mrc", got, ref_mrc(base, x1), where)
                    x1_32 = x1.to(torch.int32)
                    for layout, t in (("tile", tiles(x1)), ("rows", x1_32.T)):
                        hold("mrc", mrc_kernel_call(t, image),
                             mrc_plain(t, inv, m), dict(where, layout=layout))
                    # modmul
                    got = ops.modmul_op(base, x1, x2)
                    require(got.dtype == dtype, f"modmul_op dtype at {where}")
                    hold("modmul", got, ref_modmul(base, x1, x2), where)
                    worst = (m - 1).to(dtype).expand(batch, n)
                    hold("modmul", ops.modmul_op(base, worst, worst),
                         ref_modmul(base, worst, worst), dict(where, worst=True))
                    # compare, operands with m_a channels from the plain normalize
                    with backend("torch"):
                        A = RnsArray.from_parts(base, x1, device=dev).normalize(
                            Layout.BASE_MA)
                        B = RnsArray.from_parts(base, x2, device=dev).normalize(
                            Layout.BASE_MA)
                    got = ops.compare_op(A, B)
                    hold("compare", got, ref_compare(base, A.x, A.xa, B.x, B.xa),
                         where)
                    # the kernel call on channel-major tiles and on the
                    # packed (batch, n + 1) rows in place, vs the plain
                    # version; and mrc on the packed rows' base channels
                    pa, pb = (P.to_packed().to(torch.int32) for P in (A, B))
                    views = {
                        "tile": (tiles(A.x), A.xa.to(torch.int32).contiguous(),
                                 tiles(B.x), B.xa.to(torch.int32).contiguous()),
                        "packed": (pa[:, :n].T, pa[:, n], pb[:, :n].T, pb[:, n])}
                    for layout, (t1, a1, t2, a2) in views.items():
                        at = dict(where, layout=layout)
                        hold("compare",
                             compare_kernel_call(t1, a1, t2, a2, image, base.ma),
                             compare_plain(t1, a1, t2, a2, inv, m, betas, base.ma),
                             at)
                    hold("mrc", mrc_kernel_call(pa[:, :n].T, image),
                         mrc_plain(pa[:, :n].T, inv, m), dict(where, layout="packed"))
                    # a self-comparison is always true: both branches covered
                    require(bool(ops.compare_op(A, A).all()), f"A >= A at {where}")
                    cases += 1
    torch.cuda.synchronize()
    emit({"phase": "parity", "cases": cases, "skipped": skipped,
          "layouts": {"mrc": ["tile", "rows", "packed"],
                      "compare": ["tile", "packed"]},
          "max_abs_err": {k: max_err[k] for k in ("mrc", "modmul", "compare")},
          "exact": True})
    cases = codec_parity(dev, max_err)
    emit({"phase": "parity", "kernels": "codec", "cases": cases,
          "codecs": list(CODEC_SWEEP), "batches": list(SWEEP_BATCHES),
          "max_abs_err": {k: max_err[k] for k in ("codec_encode",
                                                  "codec_decode")},
          "exact": True})

    # ----------------------------------------------------- 4. main path
    def counts():
        return {"mrc": ops.mrc_op.launches, "modmul": ops.modmul_op.launches,
                "compare": ops.compare_op.launches}

    def delta(before):
        now = counts()
        return {k: now[k] - before[k] for k in now}

    ops.reset_launches()
    t0 = time.perf_counter()
    qs = quickstart.main(dev, verbose=False)
    torch.cuda.synchronize()
    got = counts()
    nbits = make_base(4, bits=8).M.bit_length()
    # quickstart's kernel calls: mrc — classic compare 2, to_int of q, r and
    # the scaled value 3, three halvings 3, two normalize 2; compare — step 3
    # 1, divmod 2*nbits+1, step 6 1; modmul — one per halving, 3
    want = {"mrc": 10, "modmul": 3, "compare": 2 * nbits + 3}
    require(got == want, f"quickstart launches {got}, expected {want}")
    emit({"phase": "main", "step": "quickstart", "seconds": time.perf_counter() - t0,
          "launches": got, "verdicts": int(qs["verdicts"].sum()),
          "batch": int(qs["verdicts"].size)})

    main_tiles = {}

    def width_run(label, base, batch):
        before = counts()
        t0 = time.perf_counter()
        x1 = residues(base, (batch,))
        x2 = residues(base, (batch,))
        A = RnsArray.from_parts(base, x1, device=dev).normalize(Layout.BASE_MA)
        B = RnsArray.from_parts(base, x2, device=dev).normalize(Layout.BASE_MA)
        ge = A >= B
        prod = A * B
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = delta(before)
        want = {"mrc": 2, "modmul": 1, "compare": 1}
        require(got == want, f"{label} launches {got}, expected {want}")
        # plain versions on the card, bit for bit
        with backend("torch"):
            A_p = RnsArray.from_parts(base, x1, device=dev).normalize(Layout.BASE_MA)
            require(torch.equal(A.residues, A_p.residues),
                    f"{label}: normalize differs from the plain route")
        require(torch.equal(ge, ref_compare(base, A.x, A.xa, B.x, B.xa)),
                f"{label}: >= differs from the plain version")
        red = base.tensor(("moduli_with", (base.ma,)), dev, torch.int32)
        want_prod = torch.remainder(A.residues * B.residues, red)
        require(torch.equal(prod.residues, want_prod),
                f"{label}: product differs from the plain version")
        # host big-int oracle on sampled columns
        cols = torch.randperm(batch, generator=gen, device=dev)[:ORACLE_COLUMNS]
        ax, bx = A.x[cols].cpu().numpy(), B.x[cols].cpu().numpy()
        aa, ba = A.xa[cols].cpu().numpy(), B.xa[cols].cpu().numpy()
        gs, px = ge[cols].cpu().numpy(), prod.residues[cols].cpu().numpy()
        for i in range(len(cols)):
            va, vb = rns_to_int(base, ax[i]), rns_to_int(base, bx[i])
            require(int(aa[i]) == va % base.ma and int(ba[i]) == vb % base.ma,
                    f"{label}: m_a channel differs from the oracle")
            require(bool(gs[i]) == (va >= vb), f"{label}: verdict differs "
                    "from the big-int oracle")
            require(rns_to_int(base, px[i][: base.n]) == va * vb % base.M
                    and int(px[i][base.n]) == va * vb % base.ma,
                    f"{label}: product differs from the big-int oracle")
        emit({"phase": "main", "step": label, "n": base.n, "batch": batch,
              "seconds": seconds, "launches": got, "true_share":
              float(ge.float().mean()), "oracle_columns": len(cols)})
        main_tiles[label] = (base, A, B, got)

    paper = make_paper_bases()[0]
    width_run("paper_n137", paper, PAPER_BATCH)
    width_run("quickstart_n8", make_base(8, bits=15), SMALL_BATCH)
    launches = implied(**counts())   # summed over the five main paths
    emit({"phase": "main", "step": "total", "launches": counts()})

    # ------------------------------------ 5. codec: slice 2's main path
    torch.cuda.set_device(dev)
    dist.init_process_group(DIST_BACKEND, store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        codec_run = codec_main_path(dev, dist.group.WORLD, max_err)
    finally:
        dist.destroy_process_group()
    for k in launches:
        launches[k] += codec_run["launches"][k]
    emit({"phase": "codec", "step": "total", "model": MODEL_NAME,
          **codec_run})
    emit({"phase": "codec", "step": "replicas", **codec_replicas(dev)})
    emit({"phase": "codec", "step": "rrns", **codec_rrns(dev)})

    # ---------------------------------- 5b. train: slice 4's main path
    train = train_main_path(dev, max_err)
    for k in launches:
        launches[k] += train["launches"][k]
    emit({"phase": "train", "step": "total", **train})
    e2e = e2e_path(dev)
    emit({"phase": "train", "step": "train_e2e", **e2e, "card": card})

    # -------------------------- 5e. ckpt: slice 9's checkpointed training
    ck = ckpt_main_path(dev, max_err, train["fp32_step_ms_median"])
    for k in launches:
        launches[k] += ck["launches"][k]
    emit({"phase": "ckpt", "step": "total", **ck, "card": card})
    rest = ck["restore"]
    print(f"ckpt: gemma3-1b full width, {ck['layers']} layers, {card}: "
          f"{ck['wire_bytes']} bytes of rrns-v1 state, snapshot "
          f"{ck['snapshot_ms']:.1f} ms on the training thread, writer "
          f"{ck['writer_seconds']:.1f} s (encode {ck['encode_s']:.1f}, "
          f"write+fsync {ck['write_fsync_s']:.1f}, sha {ck['sha_s']:.1f}; "
          f"{ck['write_fsync_gb_per_s']:.3f} GB/s), step ms "
          f"{[round(x, 1) for x in ck['save_step_ms']]} with the save in "
          f"flight at step {ck['in_flight_step']} (5b median "
          f"{ck['fp32_step_ms_median']:.1f}); restore {rest['seconds']:.1f} "
          f"s (read {rest['read_s']:.1f}, decode {rest['decode_s']:.1f}, "
          f"sha {rest['sha_s']:.1f}, repair {rest['repair_s']:.1f}), "
          f"repaired_leaves {ck['repaired_leaves']}, resumed params equal "
          f"the uninterrupted run's; train_e2e {e2e['ms_per_step']:.1f} ms/step, final loss "
          f"{e2e['final_loss']:.4f}", flush=True)

    # ---------------------------------- 5f. mesh: slice 10's sharding
    mesh = mesh_main_path(dev, max_err)
    for k in launches:
        launches[k] += mesh["launches"][k]
    emit({"phase": "mesh", "step": "total", **{k: v for k, v in mesh.items()
                                               if k != "train"},
          "train_zero1_m_placements": mesh["train"]["zero1_m_placements"],
          "restore": ck["mesh_restore"], "card": card})
    tr, sv, dr = mesh["train"]["steps"], mesh["serve"], mesh["dryrun"]
    mr = ck["mesh_restore"]
    print(f"mesh: gemma3-1b on a (1, 1) mesh, {card}: step ms mesh / no "
          f"mesh {[(round(r['mesh_ms'], 1), round(r['plain_ms'], 1)) for r in tr]}"
          f" (fp32 x{MESH_FP32_STEPS}, codec x{MESH_CODEC_STEPS}; codec "
          f"launches a step {tr[-1]['mesh_launches']}), parameters "
          f"bit-equal; paged decode step {sv['mesh_decode_ms_median']:.2f} "
          f"ms with mesh= against {sv['plain_decode_ms_median']:.2f} ms, "
          f"tokens and pool equal; restore onto the mesh "
          f"{mr['shardings_s']:.1f} s against {mr['device_s']:.1f} s, "
          f"bit-equal; dry run train_4k on (16, 16): "
          f"{dr['train_4k']['memory']['per_device_bytes']} bytes a device, "
          f"fits {dr['train_4k']['memory']['fits_hbm']}; prefill_32k "
          f"{dr['prefill_32k']['memory']['per_device_bytes']} bytes; in "
          f"{mesh['seconds']:.1f} s",
          flush=True)

    # ------------------------ 5g. flash: slice 11's chunked attention
    flash = flash_main_path(dev, max_err)
    for k in launches:
        launches[k] += flash["launches"][k]
    emit({"phase": "flash", "step": "total", **flash,
          "dryrun_prefill_32k": dr["prefill_32k"], "card": card})
    ft, fa, ftf = flash["train"], flash["agreement"], flash["teacher_forced"]
    print(f"flash: gemma3-1b full width and depth, {card}: prefill of "
          f"{FLASH_PROMPT} tokens {flash['prefill_ms']:.1f} ms (CUDA events)"
          f", {flash['prefill_ops']} launching ops, peak "
          f"{flash['prefill_peak_bytes']} bytes above the parameters; decode "
          f"step {statistics.median(flash['decode_ms']):.2f} ms (median of "
          f"{FLASH_DECODE}), logits within {ftf['max_abs_diff']:.4f} of the "
          f"teacher-forced forward (bound {ftf['tolerance']:.4f}); at "
          f"{FLASH_AGREE} tokens chunked against whole rows "
          f"{fa['last_max_abs_diff']:.4f} (bound {fa['tolerance']:.4f}), "
          f"peak {fa['chunked_prefill_peak_bytes']} against "
          f"{fa['whole_rows_prefill_peak_bytes']} bytes, "
          f"{fa['decided_tokens_equal']}/{fa['decided_tokens']} decided "
          f"tokens equal; train batch 1 x {FLASH_AGREE} step ms vjp "
          f"{ft['runs']['vjp']['step_ms']}, codec {ft['runs']['rns']['step_ms']}"
          f", unrolled {ft['runs']['unrolled']['step_ms']}, update ratio "
          f"{ft['update_ratio_vjp_vs_unrolled']:.4f}; dry run prefill_32k "
          f"{dr['prefill_32k']['memory']['per_device_bytes']} bytes a device;"
          f" in {flash['seconds']:.1f} s", flush=True)

    # ------------------------------------- 6. crypto: slice 3's main path
    t0 = time.perf_counter()
    sweep = crypto_parity(dev, max_err)
    emit({"phase": "parity", "kernels": "mont", **sweep,
          "seconds": time.perf_counter() - t0,
          "max_abs_err": {k: max_err[k] for k in ("mont_mul", "mont_ladder")},
          "exact": True})
    crypto_run = crypto_main_path(dev)
    for k in launches:
        launches[k] += crypto_run["launches"][k]
    emit({"phase": "crypto", "step": "lane", **crypto_run})
    emit({"phase": "crypto", "step": "frontends", **crypto_frontends(dev)})

    # ---------------------------------------- 6b. serve: slice 5's main path
    serve = serve_main_path(dev, max_err)
    for k in launches:
        launches[k] += serve["launches"][k]
    main_run = serve["main"]
    emit({"phase": "serve", "step": "main", "args": list(SERVE_ARGS),
          **{k: v for k, v in main_run.items()
             if k not in ("invariance", "consistency")}, "card": card})
    emit({"phase": "serve", "step": "invariance",
          "requests": main_run["invariance"]})
    emit({"phase": "serve", "step": "consistency",
          "requests": main_run["consistency"]})
    emit({"phase": "serve", "step": "mixed", "args": list(SERVE_MIXED_ARGS),
          **serve["mixed"]})
    print(f"serve: gemma3-1b full width, {card}: wall "
          f"{main_run['wall_s']} s, {main_run['tok_per_s']} tokens/s, decode "
          f"step {main_run['decode_ms_median']:.3f} ms (CUDA events, median) "
          f"and {main_run['decode_host_ms_median']:.3f} ms host to enqueue, "
          f"prefill chunk of 256 {main_run['prefill_chunk_ms_median']:.3f} "
          f"ms, TTFT {main_run['ttft_ticks']['p50']} ticks / "
          f"{main_run['ttft_ms']['median']:.1f} ms (median), fingerprint "
          f"{main_run['fingerprint_ms']:.3f} ms, peak memory "
          f"{main_run['peak_memory_of_run']} bytes above the run's start",
          flush=True)

    # ---------------------------------- 6c. paged: slice 6's main path
    paged = paged_main_path(dev, max_err)
    for k in launches:
        launches[k] += paged["launches"][k]
    for part in ("sim", "batched", "offline", "mixed", "loadgen"):
        emit({"phase": "paged", "step": part, **paged[part], "card": card})
    sim, mono, off = paged["sim"], paged["batched"], paged["offline"]
    print(f"paged: gemma3-1b full width, {card}: decode step "
          f"{sim['decode_ms_median']:.3f} ms paged against "
          f"{mono['decode_ms_median']:.3f} ms batched (CUDA events, median; "
          f"host {sim['decode_host_ms_median']:.3f} / "
          f"{mono['decode_host_ms_median']:.3f} ms), prefill call "
          f"{sim['prefill_call_ms_median']:.3f} / "
          f"{mono['prefill_call_ms_median']:.3f} ms; pages in use peak "
          f"{sim['pages_in_use_peak']} against {sim['pages_mapped_peak']} "
          f"unshared, {sim['paging']['dedup_hits']} dedup hits, "
          f"{sim['paging']['cow_copies']} copies; offline "
          f"{off['tok_per_s']:.1f} tokens/s, TTFT p50 "
          f"{off['ttft_s']['p50']:.3f} s, latency p50 "
          f"{off['latency_s']['p50']:.3f} s; loadgen max QPS "
          f"{paged['loadgen']['max_qps']}", flush=True)

    # ------------------------------ 6g. warm: slice 9's warm restart
    warm = warm_main_path(dev)
    for k in launches:
        launches[k] += warm["launches"][k]
    emit({"phase": "warm", "step": "total", **warm, "card": card})
    print(f"warm: gemma3-1b full width, {card}: cold run "
          f"{warm['cold']['seconds']:.1f} s persisted "
          f"{warm['cold']['warm_restart']['pages_saved']} pages in "
          f"{warm['state_bytes_written']} bytes (pool reckoned "
          f"{warm['pool_reckoned']['pool_bytes']} bytes, "
          f"{warm['pool_reckoned']['wire_bytes']} of wire); second run "
          f"{warm['warm']['seconds']:.1f} s adopted "
          f"{warm['warm']['warm_restart']['adopted']} after repairing "
          f"{warm['warm']['warm_restart']['ckpt_repaired_leaves']} leaf, "
          f"{warm['revalidation_encode_launches']} codec_encode launches "
          f"revalidating, {warm['warm']['dedup_hits']} dedup hits, tokens "
          f"equal", flush=True)

    # --------------------- 6h. replicas: offline replicas over ranks
    reps = replicas_main_path(dev)
    for k in launches:
        launches[k] += reps["launches"][k]
    emit({"phase": "replicas", "step": "total", **reps, "card": card})
    one = reps["one_process"]
    print(f"replicas: gemma3-1b full width, {card}: {reps['world']} "
          f"processes, 2 replicas of one rank: wall {reps['wall_s']:.3f} s, "
          f"{reps['tok_per_s']:.1f} tokens/s (one process "
          f"{one['wall_s']:.3f} s, {one['tok_per_s']:.1f} tokens/s), "
          f"dispatched {reps['dispatched']}, exchange "
          f"{reps['control']['exchange_ms']['p50']:.3f} ms median / "
          f"{reps['control']['exchange_ms']['p99']:.3f} ms p99 over "
          f"{reps['control']['exchanges']} ticks on rank 0, peak memory "
          f"{reps['max_memory_allocated_by_rank']} bytes; phase "
          f"{reps['seconds']:.1f} s", flush=True)

    # --- 5c, 5d, 6d, 6e, 6f: slices 7 and 8, the moe, vlm, ssm, hybrid and
    # encdec families
    # a rounded router flips experts near ties: nothing may turn TF32 on
    require(not torch.backends.cuda.matmul.allow_tf32
            and torch.get_float32_matmul_precision() == "highest",
            "TF32 is on for f32 matmuls")
    del paged, serve
    moe_train = moe_train_path(dev, max_err)
    family_train = family_train_path(dev, max_err)
    moe = moe_serve_path(dev, max_err)
    vlm = vlm_single_shot_path(dev)
    family_serve = family_single_shot_path(dev)
    for run in (moe_train, family_train, moe):
        for k in launches:
            launches[k] += run["launches"][k]
    emit({"phase": "moe_train", "step": "total", **moe_train, "card": card})
    for part in ("main", "no_drop", "paged", "batched", "offline"):
        emit({"phase": "moe_serve", "step": part, **moe[part], "card": card})
    emit({"phase": "moe_serve", "step": "total", "seconds": moe["seconds"],
          "memory_allocated_at_start": moe["memory_allocated_at_start"],
          "launches": moe["launches"], "card": card})
    emit({"phase": "vlm", "step": "single_shot", **vlm, "card": card})
    emit({"phase": "family_train", "step": "total", **family_train,
          "card": card})
    emit({"phase": "family_serve", "step": "total",
          "seconds": family_serve["seconds"], "card": card})
    mm, nd = moe["main"], moe["no_drop"]["teacher_forced"]
    print(f"moe: {MOE_ARCH} full width and depth, {card}: wall "
          f"{mm['wall_s']} s, {mm['tok_per_s']} tokens/s, decode step "
          f"{mm['decode_ms_median']:.3f} ms (CUDA events, median) and "
          f"{mm['decode_host_ms_median']:.3f} ms host to enqueue, prefill "
          f"chunk of 256 {mm['prefill_call_ms_median']:.3f} ms, peak memory "
          f"{mm['max_memory_allocated']} bytes; paged decode step "
          f"{moe['paged']['decode_ms_median']:.3f} ms; no-drop logits "
          f"within {max(c['max_abs_diff'] for c in nd['float32'])} of the "
          f"forward in f32 ({max(c['max_abs_diff'] for c in nd['bfloat16'])}"
          f" in bf16); offline "
          f"{moe['offline']['tok_per_s']:.1f} tokens/s; train drift "
          f"{moe_train['drift']:.5f}; phases 5c {moe_train['seconds']:.1f} "
          f"s, 6d {moe['seconds']:.1f} s, 6e {vlm['phase_seconds']:.1f} s",
          flush=True)
    ft, fs = family_train["runs"], family_serve["runs"]
    print(f"ssm/hybrid/encdec: full width and depth, {card}: train "
          + "; ".join(f"{a} fp32 {r['fp32_step_ms_median']:.1f} ms "
                      f"({r['fp32_tokens_per_s_median']:.0f} tokens/s), "
                      f"codec {r['rns_step_ms_median']:.1f} ms, drift "
                      f"{r['drift']:.5f}, peak {r['max_memory_allocated']} "
                      f"bytes" for a, r in ft.items())
          + "; single-shot "
          + "; ".join(f"{a} {r[r['held_on']]['tok_per_s']} tokens/s, decode "
                      f"step {r[r['held_on']]['decode_ms_median']:.2f} ms, "
                      f"held on {r['held_on']}" for a, r in fs.items())
          + f"; phases 5d {family_train['seconds']:.1f} s, 6f "
          f"{family_serve['seconds']:.1f} s", flush=True)

    # -------------------------------------------------------- 7. timing
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.split()[0])

    def bound(nbytes, mix, units):
        """Least time in ms: bytes over the memory rate, or the busiest
        pipe's work over its peak; and which one sets it."""
        ms = {pipe: 1e3 * units * count
              / (INT8_TENSOR_OPS_PER_S if pipe == "int8_tensor" else
                 PIPE_PER_SM_CLOCK[pipe] * sms * clock_mhz * 1e6)
              for pipe, count in mix.items()}
        ms["bytes"] = 1e3 * nbytes / HBM_BYTES_PER_S
        pipe = max(ms, key=ms.get)
        return ms[pipe], "bytes" if pipe == "bytes" else "operations", pipe, ms

    timings = {}

    def column_row(name, label, base, A, B, per_call):
        """One timing row of mrc or compare on the (batch, n + 1) rows of A
        and B as the main path holds them (the kernel call reads them in
        place), held against the plain version first."""
        n, batch = base.n, A.shape[0]
        inv = base.tensor("inv_tri_np", dev, torch.int32)
        m = base.tensor("moduli_np", dev, torch.int32)
        betas = base.tensor("betas_ma_np", dev, torch.int32)
        image = ops._column_image(base, dev)
        t1, a1, t2, a2 = A.x.T, A.xa, B.x.T, B.xa
        if name == "mrc":
            kern = lambda: mrc_kernel_call(t1, image)
            plain = lambda: mrc_plain(t1, inv, m)
        else:
            kern = lambda: compare_kernel_call(t1, a1, t2, a2, image, base.ma)
            plain = lambda: compare_plain(t1, a1, t2, a2, inv, m, betas,
                                          base.ma)
        hold(name, kern(), plain(), label)
        ms = median_ms(kern)
        row = {"phase": "timing", "kernel": name, "shape": label, "n": n,
               "batch": batch, "layout": "rows in place", "ms": ms,
               "ms_back_to_back": median_ms(kern, inner=10),
               "ms_device": median_ms(kern, inner=10, queued=True),
               "plain_ms": median_ms(plain, runs=5 if batch == 1 else 20,
                                     warmup=1)}
        mix = column_work(name, n)
        nbytes = column_bytes(name, n, batch, image.numel())
        bound_ms, bound_by, pipe, pipe_ms = bound(nbytes, mix, batch)
        row.update({"bound_ms": bound_ms, "bound_by": bound_by,
                    "bound_pipe": pipe, "bound_share": bound_ms / ms,
                    "bound_share_back_to_back":
                        bound_ms / row["ms_back_to_back"],
                    "pipe_ms": pipe_ms, "bytes": nbytes,
                    "instructions": {p: batch * c for p, c in mix.items()},
                    "sms": sms, "clock_max_mhz": clock_mhz,
                    "launches_per_call": per_call, "card": card})
        emit(row)
        timings[(name, label)] = row

    for label, (base, A, B, per_call) in main_tiles.items():
        n, batch = base.n, A.shape[0]
        for name in ("mrc", "compare"):
            column_row(name, label, base, A, B, per_call[name])
        mred = base.tensor(("moduli_with", (base.ma,)), dev, torch.int32)
        p1, p2 = tiles(A.residues), tiles(B.residues)
        kern = lambda: modmul_kernel_call(p1, p2, mred)
        plain = lambda: modmul_plain(p1, p2, mred)
        nbytes, units = 12 * (n + 1) * batch + 4 * (n + 1), (n + 1) * batch
        ms = median_ms(kern)
        plain_ms = median_ms(plain, runs=20, warmup=1)
        mix = column_mix("modmul", n)
        bound_ms, bound_by, pipe, pipe_ms = bound(nbytes, mix, units)
        row = {"phase": "timing", "kernel": "modmul", "shape": label, "n": n,
               "batch": batch, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_pipe": pipe, "bound_share": bound_ms / ms,
               "pipe_ms": pipe_ms, "bytes": nbytes,
               "instructions": {p: units * c for p, c in mix.items()},
               "sms": sms, "clock_max_mhz": clock_mhz,
               "launches_per_call": per_call["modmul"], "card": card}
        emit(row)
        timings[("modmul", label)] = row

    # the codec kernels on the whole gemma3-1b gradient buffer; the plain
    # versions walk it in CHUNK-element pieces, as the main path's checks do
    codec = GradCodec.make(world=REPLICAS)
    enc, enc_kw, dec, dec_kw = codec_tables(codec)
    flat = torch.cat([seeded_grad(model_tree()[name], grad_seed(1, i), dev)
                      .view(-1) for i, name in enumerate(leaf_order())])
    wire = codec_encode_kernel_call(flat, *enc, **enc_kw)
    B, nch, n = flat.numel(), wire.shape[0], codec.base.n

    def plain_encode():
        for a in range(0, B, CHUNK):
            codec_encode_plain(flat[a : a + CHUNK], *enc, **enc_kw)

    def plain_decode():
        for a in range(0, B, CHUNK):
            codec_decode_plain(wire[:, a : a + CHUNK], *dec, **dec_kw)

    # name: (kernel, plain version, bytes moved, units, channels)
    codec_work = {
        "codec_encode": (lambda: codec_encode_kernel_call(flat, *enc, **enc_kw),
                         plain_encode, 4 * B + 4 * nch * B, B, nch),
        "codec_decode": (lambda: codec_decode_kernel_call(wire, *dec, **dec_kw),
                         plain_decode, 4 * n * B + 4 * B, B, n),
    }
    for name, (kern, plain, nbytes, units, chans) in codec_work.items():
        ms = median_ms(kern)
        plain_ms = median_ms(plain, runs=3, warmup=1)
        mix = column_mix(name, chans)
        bound_ms, bound_by, pipe, pipe_ms = bound(nbytes, mix, units)
        row = {"phase": "timing", "kernel": name, "shape": MODEL_NAME,
               "n": chans, "batch": B, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_pipe": pipe, "bound_share": bound_ms / ms,
               "pipe_ms": pipe_ms, "bytes": nbytes,
               "instructions": {p: units * c for p, c in mix.items()},
               "sms": sms, "clock_max_mhz": clock_mhz,
               "launches_per_call": 1, "card": card}
        emit(row)
        timings[(name, MODEL_NAME)] = row
    del flat, wire

    # the Montgomery kernels at RSA-2048 width on CRYPTO_TIMING_BATCH and
    # on CRYPTO_SLOTS columns: 512 distinct columns tiled (the kernels run
    # in constant time, whatever the data), each output held against the
    # plain version once
    from repro_torch.kernels.mont_ladder import (mont_ladder_kernel_call,
                                                 mont_ladder_plain,
                                                 mont_mul_kernel_call,
                                                 mont_mul_plain)

    ctx = CryptoContext(n_limbs=CRYPTO_LIMBS, exp_bits=CRYPTO_EXP_BITS)
    tables = ops._mont_tables(ctx.baseB, ctx.baseBp, ctx.lo_targets, dev)
    image = ops._mont_image(ctx.baseB, ctx.baseBp, ctx.lo_targets, dev)
    base_cols = crypto_columns(ctx, 512, random.Random(8192), dev)
    shape = (ctx.n, ctx.nch_lo, ctx.n_hi)
    for label, batch in ((CRYPTO_SHAPE, CRYPTO_TIMING_BATCH),
                         (CRYPTO_LANE_SHAPE, CRYPTO_SLOTS),
                         (CRYPTO_ONE_SHAPE, 1)):
        cols = [c.repeat(1, -(-batch // 512))[:, :batch].contiguous()
                for c in base_cols]
        bit = torch.randint(0, 2, (batch,), generator=gen, device=dev,
                            dtype=torch.int32)
        xl, xh, yl, yh, neg, nhi = cols
        lad = (xl, xh, yl, yh, bit, neg, nhi)
        mont_work = {
            "mont_mul": (lambda: mont_mul_kernel_call(*cols, image),
                         lambda: mont_mul_plain(*cols, *tables)),
            "mont_ladder": (lambda: mont_ladder_kernel_call(*lad, image),
                            lambda: mont_ladder_plain(*lad, *tables)),
        }
        for name, (kern, plain) in mont_work.items():
            for g, w in zip(kern(), plain()):
                err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                max_err[name] = max(max_err[name], err)
                require(err == 0, f"{name} kernel disagrees with its plain "
                        f"version at {label}")
            ms = median_ms(kern)
            ms_back_to_back = median_ms(kern, inner=10)
            plain_ms = median_ms(plain, runs=5, warmup=1)
            mix = mont_mix(name, *shape)
            nbytes = mont_bytes(name, *shape, batch, image.numel())
            bound_ms, bound_by, pipe, pipe_ms = bound(nbytes, mix, batch)
            row = {"phase": "timing", "kernel": name, "shape": label,
                   "n": ctx.n, "nch_lo": ctx.nch_lo, "n_hi": ctx.n_hi,
                   "batch": batch, "ms": ms,
                   "ms_back_to_back": ms_back_to_back, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_pipe": pipe, "bound_share": bound_ms / ms,
                   "pipe_ms": pipe_ms, "bytes": nbytes,
                   "instructions": {p: batch * c for p, c in mix.items()},
                   "sms": sms, "clock_max_mhz": clock_mhz,
                   "launches_per_call": 1, "card": card}
            emit(row)
            timings[(name, label)] = row
        del cols, lad

    # mrc and compare on one column of the lane's base (n = 138 and m_a),
    # the packed (1, n + 1) rows a divmod hands each of its Algorithm-1
    # comparisons
    base = ctx.baseB
    with backend("torch"):
        lhs, rhs = (RnsArray.from_parts(base, residues(base, (1,)),
                                        device=dev).normalize(Layout.BASE_MA)
                    for _ in range(2))
    for name in ("mrc", "compare"):
        column_row(name, DIVMOD_SHAPE, base, lhs, rhs, 1)
    timings[("compare", DIVMOD_SHAPE)]["launches_per_divmod"] = (
        2 * base.M.bit_length() + 1)

    # A latency floor for that column, not a bound: its triangle's n - 1
    # dependent steps, each at least as long as the cheapest kind of step,
    # one register slot a lane.  That step's time is the slope of the
    # one-column compare's device time between n = 17 and n = 32, where
    # every step is of that kind and the launch's fixed work is the same.
    step_ms = {}
    for n in FLOOR_NS:
        b = make_base(n, bits=15)
        with backend("torch"):
            lo, hi = (RnsArray.from_parts(b, residues(b, (1,)), device=dev)
                      .normalize(Layout.BASE_MA) for _ in range(2))
        img = ops._column_image(b, dev)
        args = (lo.x.T, lo.xa, hi.x.T, hi.xa)
        hold("compare", compare_kernel_call(*args, img, b.ma),
             compare_plain(*args, b.tensor("inv_tri_np", dev, torch.int32),
                           b.tensor("moduli_np", dev, torch.int32),
                           b.tensor("betas_ma_np", dev, torch.int32), b.ma),
             f"one column, n = {n}")
        step_ms[n] = median_ms(lambda: compare_kernel_call(*args, img, b.ma),
                               runs=50, inner=10, queued=True)
    lo_n, hi_n = FLOOR_NS
    ns_per_step = 1e6 * (step_ms[hi_n] - step_ms[lo_n]) / (hi_n - lo_n)
    steps = base.n - 1
    emit({"phase": "timing", "step": "latency_floor", "kernel": "compare",
          "shape": DIVMOD_SHAPE, "dependent_steps": steps,
          "ms_device_by_n": {str(k): v for k, v in step_ms.items()},
          "ns_per_step": ns_per_step,
          "floor_ms": 1e-6 * steps * ns_per_step,
          "ms_device": timings[("compare", DIVMOD_SHAPE)]["ms_device"],
          "ms": timings[("compare", DIVMOD_SHAPE)]["ms"], "card": card})

    # ------------------------------------------------------- 8. kernels
    replaces = {"mrc": "src/repro/kernels/mrc.py:33",
                "modmul": "src/repro/kernels/modmul.py:26",
                "compare": "src/repro/kernels/rns_compare.py:44",
                "codec_encode": "src/repro/kernels/codec_encode.py:83",
                "codec_decode": "src/repro/kernels/codec_decode.py:93",
                "mont_mul": "src/repro/kernels/mont_ladder.py:125",
                "mont_ladder": "src/repro/kernels/mont_ladder.py:149"}
    sources = {"mrc": "src/repro_torch/kernels/csrc/mrc.cu",
               "modmul": "src/repro_torch/kernels/csrc/modmul.cu",
               "compare": "src/repro_torch/kernels/csrc/rns_compare.cu",
               "codec_encode": "src/repro_torch/kernels/csrc/codec_encode.cu",
               "codec_decode": "src/repro_torch/kernels/csrc/codec_decode.cu",
               "mont_mul": "src/repro_torch/kernels/csrc/mont_ladder.cu",
               "mont_ladder": "src/repro_torch/kernels/csrc/mont_ladder.cu"}
    # compare at the one-column shape of the divmods and the lane's
    # canonicalisations: 17,588 of its 17,657 launches
    shape_of = {"mrc": "paper_n137", "modmul": "paper_n137",
                "compare": DIVMOD_SHAPE, "codec_encode": MODEL_NAME,
                "codec_decode": MODEL_NAME, "mont_mul": CRYPTO_SHAPE,
                "mont_ladder": CRYPTO_SHAPE}
    rows = []
    for name in replaces:
        t = timings[(name, shape_of[name])]
        rows.append({"name": name, "route": "cuda", "source": sources[name],
                     "replaces": replaces[name], "launches": launches[name],
                     "max_abs_err": max_err[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": None})
    require(all(r["launches"] > 0 for r in rows), "a kernel was never launched")
    emit({"kernels": rows})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--replica-rank"]:   # a rank of phase 6h
        sys.exit(replica_rank(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
