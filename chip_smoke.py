#!/usr/bin/env python3
"""Drive the PyTorch port on one GPU and check it end to end.

    python3 chip_smoke.py

1. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and prints
   each kernel's registers and spill bytes;
2. holds each kernel against its plain PyTorch version on the card
   (attention in bf16 and f32 at head dims 64, 80 and 128 with ragged
   lengths, query counts around the 64-row tile and strided views, and at
   seamless's group-1 shapes, causal and not, forward and backward; decode
   at GQA groups 1-8, 12 (mistral-large's 96 / 8 heads) and 24 (two row
   blocks), lengths at tile and span edges, one long slot, more
   (slot, KV head) pairs than SMs and 0-dim lengths, each case also with
   the log-sum-exps the sharded decode merges position shards by (the
   output bit-equal, the lse against the plain one); the MoE router on logits with
   ties, ids compared exactly; the fused router (product, softmax, top-k)
   at the qwen3-moe shapes, ids compared up to near ties and exactly where
   router columns repeat; the SSD state scan with and without an initial
   state; the attention backward at head dims 64, 80 and 128, GQA groups 1,
   2, 7 and 8, Sq = Sk and Sq < Sk, ragged tails around the 64-row tile
   (Sq and Sk at 63-65 and 127-129), Sq % 4 != 0 and strided views, in f32
   and bf16, against its plain closed form, and the forward's
   log-sum-exp; in f32 also both at the edges of the f32 forward's 128-row
   blocks (Sq and Sk at 127-129 and 255-257, groups 1, 2 and 3) and at
   lidc-100m's training layer; the router backward at decode and prefill row counts
   (1-4096, E = 128, k = 8), with and without the probabilities' gradient
   and with repeated probabilities, against its closed form, and the
   registered router op's dx and drouter against autograd through the
   plain router with the kernel's routing); the reverse state scan at phase
   11's block, a P*N off the 16-byte path, one chunk and a (b, h) pair
   split over eight blocks, with and without an initial state and the
   final state's gradient,
   against its closed form and autograd through the plain scan, bit-equal
   when run twice, and the registered scan op's gradients against
   autograd);
3. serves qwen3-1.7b at full width and depth (random weights from a seeded
   ``torch.Generator``) through ``ServeEngine``: 12 requests, prompts of
   8-1500 tokens, 32 new tokens each, mixed priorities, 8 slots; then one
   prompt of exactly ``max_seq`` tokens, which must finish at prefill;
4. runs one prompt teacher-forced through the kernel path and the plain path
   and bounds the logit gap;
5. serves zamba2-2.7b (hybrid, full width and depth) through
   ``make_prefill`` / ``make_serve_step``: 4 prompts of 700 tokens, 32
   greedy steps; then its teacher-forced bound;
6. serves qwen3-moe-30b-a3b (full width, all 48 layers, 56.9 GiB of bf16
   weights drawn on the card) the same way: 4 prompts of 300 tokens, 16
   greedy steps, and profiles the decode step once more with the router
   chain the port ran before ``moe_router`` (cast, cuBLAS product,
   ``moe_gating``, softmax); then its teacher-forced bound at full width
   and 4 layers;
7. times each kernel at the serving shapes of phases 3, 5 and 6 (both
   attention kernels at all three GQA groups: 2, 1 and 8) beside its
   bound, its plain version and one PyTorch library call where one exists,
   with L2 flushed by writing and by reading 256 MB, and prints the table
   as JSON; the attention backward at phase 8's layer shape beside its
   bound, its plain version and autograd through PyTorch's SDPA; the
   router backward at phase 10's shape beside its bound, its plain version
   and the two f32 products that follow it; and the state scan and its
   reverse at phase 11's Mamba2 block; seamless's encoder layer (serving
   and training), its training layer's backward and its cross-attention
   decode at a 0-dim length (launches and device us from phase 13); the f32
   paths of both attention kernels (the CUDA cores, exact f32) at
   seamless's encoder shape and at lidc-100m's training layer (launches
   and device us from phase 14), beside SDPA in f32; every kernel
   also beside the time of a one-element PyTorch op, the floor of any
   launch;
8. trains qwen3-1.7b at full width and depth (1.72 B params, bf16, f32
   AdamW moments) through ``run_training``: 10 steps of 4 x 1024 synthetic
   tokens, checkpoints every 5 steps into an in-memory lake.  Gates: the
   kernel path's gradients against the plain bf16 and f32 paths on one
   batch, and bit-equal when run twice; 28 forward and 28 backward
   attention launches per step (56 forward under remat "full" and
   "dots"); finite losses that fall; the
   latest checkpoint restored bit-equal, and two further steps from it and
   from the live state giving the same losses bit for bit.  Prints ms per
   step, tokens/s, the model-FLOPs share of 989 TFLOP/s, peak memory and the
   device's idle share over profiled steps;
9. runs the port's executors as a LIDC cluster calls them
   (``repro_torch.runtime``): the train executor on phase 8's run (10 steps,
   a checkpoint every 5, so two phases), once whole on one lake, then on a
   fresh lake phase 0 on a cluster that dies and the whole plan again from
   another, which must resume from step 5 and end on a loss bit-equal to
   the whole run's, under checkpoint names ``train-<job signature>``; the
   serve executor on 8 requests of 32 tokens (8 slots, ``max_seq`` 2048);
   the blast executor on the host.  Gates: the attention launches per
   trained step, per prefill and per decode step.  Prints each job's wall
   time, the cost model's virtual step times and memory estimate beside the
   measured ones, and the attention kernels' device us per step;
10. trains qwen3-moe-30b-a3b at full width, depth cut to 4 layers (3.11 B
   params, bf16, f32 AdamW moments, ~37 GB of state) through
   ``run_training``: 10 steps of 4 x 1024 synthetic tokens, the checkpoint
   of step 5 kept in an in-memory lake (one at a time: each is ~37 GB of
   host arrays).  Gates: the kernel path's gradients and its tokens'
   losses against the plain bf16 and f32 paths on one batch (the mean
   loss's error, a sum of signed errors, is printed but not gated: between
   the two bf16 paths it is a coin flip, ``scripts/moe_loss_spread.py``),
   and bit-equal when run twice;
   4 forward and 4 backward launches per step of ``moe_router`` and of
   ``flash_attention`` (8 forward under remat "full" and "dots"); finite
   losses that fall; the step-5 checkpoint restored bit-equal to the live
   state it was taken from, and steps 6-10 from it giving the run's losses
   and final state bit for bit.  Prints ms per step, tokens/s, the
   model-FLOPs share of 989 TFLOP/s (active parameters), peak memory, the
   idle share over profiled steps, and the device us per step of the
   repo's kernels and of the router backward's two products;
11. trains zamba2-2.7b at full width and depth (54 Mamba2 blocks, the
   shared block applied 9 times; 2.60 B params, bf16, f32 AdamW moments,
   ~31 GB of state) through ``run_training`` under remat "full" (each
   super-block recomputed in the backward pass): 10 steps of 4 x 1024
   synthetic tokens, warmup-cosine to 3e-4, the step-5 checkpoint kept.
   Gates as phase 10's: gradients and the tokens' losses on one batch,
   bit-equal when run twice; 18 forward and 9 backward attention launches
   and 108 forward and 54 backward scan launches per step (9 / 9 / 54 / 54
   on the gate batch under remat "none"; "dots" as "full"); finite losses
   that fall; the checkpoint restored bit-equal and steps 6-10 replayed
   bit for bit.  Prints phase 10's measures and the device us per step of both
   attention kernels and both scan kernels beside their bounds;
12. serves xlstm-350m at full width and depth (24 blocks, 3 groups of 7
   mLSTM + 1 sLSTM; 0.52 B params; no repo kernel, launches gated at 0)
   through ``make_prefill`` / ``make_serve_step``: 4 prompts of 1024
   tokens, 32 greedy steps, then a 100-token prompt, which is stepped token
   by token; in f32 at one group and full width: prefill(256) and 64 decode
   steps against prefill(320) (1e-3 of the largest logit), the mLSTM's
   parallel, chunkwise and recurrent forms against each other (atol 3e-4,
   rtol 3e-3), and the logits, loss and every gradient on the card against
   the port's CPU path in f64 (1e-4 of each tensor's largest value; the
   CPU's own f32 run's gap to f64 printed beside it); then trains
   it through ``run_training``: 4 x 1024 tokens, 6 steps, warmup-cosine
   to 3e-4, remat "none", with phase 10's repeat, loss and resume gates
   (the checkpoint at step 3, steps 4-6 replayed);
13. serves seamless-m4t-large-v2 at full width and depth (24 + 24 layers,
   2.03 B params): 4 requests of 1024 bf16 frames and one BOS each,
   ``max_seq`` 64, 32 greedy steps (72 ``flash_attention`` launches a
   prefill, 48 ``flash_decode`` launches a step), then a teacher-forced
   bound as phase 4's over 1024 frames; trains it through ``run_training``
   on ``SyntheticLM``'s frames cast to bf16 on the card (the model refuses
   frames of another dtype, as the reference does): 4 x 1024 tokens, 10
   steps, 3e-4, with phase 8's gradient gate (the tokens' losses) and
   phase 10's launch, repeat and resume gates, and the attention launches
   of a step by dtype.  Phases 12 and 13 print ms and tokens a step, the
   model-FLOPs share, peak memory, the idle share and the leading device
   ops;
14. trains lidc-100m, ``examples/train_100m.py``'s ``CONFIG_100M`` in the
   port's copy (``repro_torch.examples.train_100m``; 10 layers, d_model 640, 10/5 heads of 64, tied
   embeddings, f32; 93.6 M params), weights from a seeded generator on the
   card, through ``run_training``: 4 x 1024 tokens, 10 steps,
   warmup-cosine to the example's 1e-3, remat "none", the step-5
   checkpoint kept in an in-memory lake.  Every attention runs the f32
   kernels.  Gates: 10 forward and 10 backward attention launches a step,
   all f32; the gate batch's loss and every gradient within 1e-4 of that
   tensor's largest value on the plain f32 path on the card, and bit-equal
   when run twice; finite losses that fall; the checkpoint restored
   bit-equal and steps 6-10 replayed bit for bit.  Prints ms and tokens a
   step, the model-FLOPs share of 989 TFLOP/s and of the f32 peak (67
   TFLOP/s), peak memory, the idle share, the leading device ops and the
   attention kernels' device us a step;
15. runs ``python -m repro_torch.examples.train_100m`` (lidc-100m, f32, 4 x
   1024 tokens, 10 steps, a checkpoint every 5) on a directory lake
   (``DirLake``, the reference's on-disk layout) in a new process, kills it
   with SIGKILL once its output shows step 5 done, and runs the same
   command again, which must resume from step 5.  Gates: that process's
   losses for steps 5-9 and its step-10 checkpoint bit-equal to
   ``run_training`` here, resumed from a copy of the directory made right
   after the kill, with 10 + 10 f32 attention launches a step; every
   object file named in ``_index.json`` and every ``latest`` pointing at a
   checkpoint that reads back whole.  Prints the checkpoint's write and
   read time, the bytes on disk and each process's wall time;
16. runs two ranks on the one card, each a process started with
   ``torch.multiprocessing`` (spawn) on cuda:0: first a probe of NCCL with
   two ranks on one device (it refuses: the group is then gloo, whose
   support for CUDA tensors in each collective the ranks probe and print),
   then (a) qwen3-moe-30b-a3b's MoE block at full width in f32 over 4 x
   1024 tokens, expert parallel over a 1 x 2 ("data", "model") mesh (64
   experts a rank): y, aux and the gradients of x, the router and the
   rank's experts within 1e-4 of each tensor's largest value on the block
   run on one rank, the same routing ids, one ``moe_router`` and one
   ``moe_router_bwd`` launch a rank; (b) lidc-100m as two GPipe stages of 5
   layers, 4 x 1024 tokens in 4 microbatches: the loss and every gradient
   within 1e-4 of the sequential ``loss_fn`` on the card, 20 + 20 f32
   attention launches a rank; (c) lidc-100m's train step with
   ``compress_pods`` over 2 pods of 2 x 1024 tokens: the first step's
   gradient within the two int8 roundings' bound of the plain all-reduce
   sum, int8 handed to ``all_to_all`` and ``all_gather`` (the bytes printed
   against f32's), 10 steps twice bit-equal, finite losses that fall.  The
   wire is gloo's, staged through the host, so the phase gates
   correctness and launches, not collective time;
17. serves mistral-large-123b at full width (96 query heads over 8 KV
   heads of 128: GQA group 12, one pass of ``flash_decode`` over the cache
   with all 16 rows of its MMA) and 2 of its 88 layers (~7 GB of bf16
   weights) through ``make_prefill`` / ``make_serve_step``: 4 prompts of
   300 tokens, 16 greedy steps (2 ``flash_decode`` launches a step), then
   phase 4's teacher-forced bound; its device us per decode step fill
   phase 7's group-12 row;
18. runs named jobs through the port's own LIDC control plane
   (``repro_torch.core``, ``runtime.fleet``; nothing of ``repro``): (a)
   ``repro_torch.examples.quickstart``, three clusters of 16 H100s, the
   train job ``{"app": "train", "arch": "lidc-demo", "shape": "custom",
   "chips": 4, "steps": 15}`` (the paper's own 4-layer payload at full
   size) placed with no cluster addressed, its result fetched by name, and
   its repeat answered with no new job and no launch; (b)
   ``repro_torch.examples.multicluster_failover``: 20 steps, a checkpoint
   every 5, the cluster that runs the job failed right after its step-10
   checkpoint, ``resilient_run`` completing it on the other cluster from
   step 10, its final loss bit-equal to the same job run unbroken through a
   fresh overlay; (c) the serve job ``{"app": "serve", "arch":
   "qwen3-1.7b", "requests": 8, "new_tokens": 32}`` (full width and depth)
   expressed into a ``LidcSystem`` whose one-card cluster has phase 9's
   endpoints, and its repeat answered from the edge's Content Store; (d) a
   blast job through the same overlay.  Gates: every job ``Completed`` with
   real compute on the card (a job's error fails the phase); 4 + 4
   attention launches per trained step; 256 tokens out, 28 prefill
   launches a request and 28 decode launches a step, no other kernel.
   Prints each job's virtual and wall seconds, the Interests, Data and
   Nacks the edge saw, and the attention kernels' device us per step;
19. carries named sessions and named KV across a cluster failure, through
   the port's serving plane, fetcher and overlay (nothing of ``repro``):
   (a) ``repro_torch.examples.serving_failover`` (three clusters, a
   64-token prompt, 80 tokens, the serving cluster failed at virtual
   1.5 s), its stream held to the ``token_at`` oracle and its numbers to
   the CPU's (``FAILOVER_CPU``); (b) a real qwen3-1.7b session (full width
   and depth, bf16): engine A serves one 1,000-token prompt, its
   ``kv_checkpoint`` after the 16th token is serialised with ``np.savez``,
   published under ``datalake.kv.session_kv_name`` into a two-cluster
   ``LidcSystem``'s lake, the first cluster failed, the object fetched by
   name with ``SegmentFetcher`` from the survivor's node and restored into
   a fresh engine B, which decodes the last 16 tokens; gates: the fetched
   bytes' sha256 equal to the published bytes', B's tokens equal to A's
   last 16 (A runs on unbroken), 28 ``flash_attention`` launches in A and
   0 in B, 28 ``flash_decode`` launches a decode step in both, no other
   kernel; prints the object's bytes and segments, the fetch's virtual and
   wall seconds and the device us of a decode step in A and in B; (c)
   ``repro_torch.examples.serve_batched`` on the card (lidc-demo): 10
   engine requests, then 6 serve jobs load-shared over 3 clusters, each
   ``Completed``, on at least 2 clusters, 4 prefill launches a request and
   4 decode launches a step.

Each serving phase sets every kernel's launch count to 0 before its
prefill and before its decode steps, and checks the counts after; its
profiled decode steps give each kernel's device time per served step.
Phases 8-14 do the same around their runs and profiled steps.  The
script prints its total time, then the kernel table as JSON; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository's ``src/`` beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
SLEEP_CYCLES = 2_000_000   # ~1 ms of a spinning kernel ahead of each timed call

SERVE_ARCH = "qwen3-1.7b"
N_REQUESTS, MAX_NEW, MAX_BATCH, MAX_SEQ = 12, 32, 8, 2048
PROMPT_MIN, PROMPT_MAX = 8, 1500
TEACHER_PROMPT, TEACHER_STEPS, TEACHER_SLACK = 300, 16, 1.5
PROFILE_STEPS, PROFILE_PROMPT = 6, 512
TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # as tests/test_kernels.py
# A decode output row is a weighted mean of ~n value rows, about sqrt(e/n)
# in size (0.018 at n = 8192), so the elementwise TOL cannot see one wrong
# 64-key tile of a long slot.  Each (slot, query head) row's error is also
# held to this share of the row's own size: above the sound kernel's
# readings, below those of planted faults (scripts/decode_variants.py
# faults; both in PERF.md).
DECODE_REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# moe_router sums its f32 logits over D in another order than cuBLAS, so at
# D = 2048 its logits differ from the plain version's by ~2e-6, and where two
# probabilities are that close the top-k may pick differently.  At every
# rank the kernel's expert must have a plain probability within this of the
# plain choice's: at least 10x the largest |d log p| phase 2 reads (|d p| <=
# p |d log p| <= |d log p|; phase 2 checks the 10x), far below the planted
# faults' (scripts/router_variants.py faults; both in PERF.md).
ROUTER_TIE_DELTA = 1e-4

# The attention backward's gradients are also held row by row (a query's or
# a key's head vector) to this share of the row's size, floored at 0.1 of
# the median row's: the rows that cancel to about nothing (a query that
# sees one key has dS = dP - D = 0) read rounding noise over a zero, ~1e-5
# of the median row in f32 (grad_row_rel_err).
GRAD_ROW_TOL = {"float32": 1e-3, "bfloat16": 2e-2}

# phase 8: (arch, batch, sequence, steps, checkpoint every, peak lr)
TRAIN_RUN = ("qwen3-1.7b", 4, 1024, 10, 5, 3e-3)
GATE_BATCH = 1            # the gradient gate's batch (x the run's sequence)
TRAIN_PROFILE_STEPS = 2

# phase 9: the serve job's requests, new tokens each, slots and max_seq; its
# train job is phase 8's run (TRAIN_RUN) through the train executor
EXEC_SERVE = (8, 32, 8, 2048)

# phases 5 and 6: (arch, batch, prompt length, max_seq, greedy decode steps)
HYBRID_RUN = ("zamba2-2.7b", 4, 700, 1024, 32)
# phase 17: mistral-large-123b at full width, its depth cut to 2 of 88 layers
# (~7 GB of bf16 weights; all 88 need ~246 GB): (arch, layers, batch, prompt,
# max_seq, decode steps)
MISTRAL_RUN = ("mistral-large-123b", 2, 4, 300, 1024, 16)
MOE_RUN = ("qwen3-moe-30b-a3b", 4, 300, 512, 16)
MOE_TEACHER_LAYERS = 4      # f32 at 48 layers would need ~122 GB

# phase 10: (arch, layers kept, batch, sequence, steps, checkpoint at, peak
# lr); 48 layers of bf16 weights and gradients and f32 moments: ~370 GB
MOE_TRAIN_RUN = ("qwen3-moe-30b-a3b", 4, 4, 1024, 10, 5, 3e-3)

# phase 11: (arch, batch, sequence, steps, checkpoint at, peak lr, remat);
# under remat "none" the 54 blocks' activations (~1.5 GB each at 4 x 1024)
# would not fit beside ~31 GB of state.  At a peak of 3e-3 (phases 8 and
# 10's) or 1e-3 the loss rises again after its first steps; at 3e-4 it
# falls (scripts/hybrid_lr_sweep.py, numbers in PERF.md)
HYBRID_TRAIN_RUN = ("zamba2-2.7b", 4, 1024, 10, 5, 3e-4, "full")

# phase 12: serving (arch, batch, prompt length, greedy decode steps, a short
# prompt off the chunk, stepped token by token); the f32 gates at one group
# (prefill length, decode steps after it; gate-batch tokens); training
# (batch, sequence, steps, checkpoint at, peak lr, remat): 6 steps at ~8 s
# each, not 10, keep the script inside its 1,200 s on a slower host
XLSTM_SERVE = ("xlstm-350m", 4, 1024, 32, 100)
XLSTM_F32 = (256, 64, 256)
XLSTM_TRAIN_RUN = (4, 1024, 6, 3, 3e-4, "none")

# phase 13: serving (arch, batch, frames, max_seq, greedy decode steps; one
# BOS token a request); training as phase 12's, on SyntheticLM's frames in
# the model's dtype
SEAMLESS_SERVE = ("seamless-m4t-large-v2", 4, 1024, 64, 32)
SEAMLESS_TRAIN_RUN = (4, 1024, 10, 5, 3e-4, "none")

# phase 14: examples/train_100m.py's CONFIG_100M, the repo's one end-to-end
# training driver (the port keeps its copy of CONFIG_100M in
# repro_torch/examples/train_100m.py); trained as (batch, sequence, steps,
# checkpoint at, the example's peak lr, remat).  Its gradient gate holds each
# tensor of the kernel path to LIDC_GRAD_TOL of that tensor's largest value on
# the plain path, both f32 on the card (phase 12's gate)
LIDC_TRAIN_RUN = (4, 1024, 10, 5, 1e-3, "none")
LIDC_GRAD_TOL = 1e-4
# phase 15: repro_torch.examples.train_100m killed and rerun on a directory
# lake: (batch, sequence, steps, checkpoint every, the step whose line
# triggers the kill, the seconds each process may take)
LAKE_RUN = (4, 1024, 10, 5, 5, 300)
# phase 16: two ranks on the one card.  EP: qwen3-moe-30b-a3b's MoE block
# (full width, f32) over (batch, sequence) tokens, model axis 2; GPipe:
# lidc-100m, 2 stages, (batch, sequence, microbatches); the compressed step:
# lidc-100m, 2 pods of (rows, sequence) tokens, steps; the seconds the ranks
# may take.  Gradients held to LIDC_GRAD_TOL of each tensor's largest value
EP_RUN = (4, 1024)
PP_RUN = (4, 1024, 4)
POD_RUN = (2, 1024, 10)
RANKS_TIMEOUT = 600
# phase 18: named jobs through the port's own LIDC overlay.  The quickstart
# (lidc-demo, 4 layers, the paper's own payload at full size) and the
# failover come from repro_torch.examples; the serve job: (arch, requests,
# new tokens), on a one-card cluster at the endpoints' own 4 slots of 64
OVERLAY_ARCH = "lidc-demo"
OVERLAY_SERVE = ("qwen3-1.7b", 8, 32)
# phase 19: (a) repro_torch.examples.serving_failover's numbers as the CPU
# gives them (the virtual clock is the same on every host); (b) a real
# session's KV carried across a cluster failure: (arch, prompt tokens, new
# tokens, the token after which A's KV is checkpointed, engine slots,
# engine max_seq); (c) repro_torch.examples.serve_batched's arch
FAILOVER_CPU = {"survivor": "pod2", "kv_bytes_fetched": 11665408.0, "kv_fetches": 1,
                "resubmits": 1, "tokens_done": 80, "killed_at": 1.75, "delivered_at_kill": 25,
                "finished_at": 5.870499999999926}
SESSION_KV_RUN = ("qwen3-1.7b", 1000, 32, 16, 4, 2048)
BATCHED_ARCH = "lidc-demo"


class Phase:
    """Prints a phase's title, then its seconds when it ends."""

    def __init__(self, title: str):
        self.title = title

    def __enter__(self):
        print(self.title)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"  phase took {time.perf_counter() - self.t0:.1f} s")


class SmokeFailure(Exception):
    pass


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi: no output"


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def max_err(out, want, tol):
    """(max |out - want|, within atol = rtol = tol elementwise)."""
    out, want = out.float(), want.float()
    err = (out - want).abs()
    return float(err.max()), bool((err <= tol + tol * want.abs()).all())


def grad_row_rel_err(out, want, tol):
    """max over rows (a query's or a key's head vector) of |out - want| /
    max(|want|, 0.1 x the median row's |want|), Euclidean norms; None where
    the median row is below ``tol`` x sqrt(hd), the size of a row of
    elementwise-tolerance errors (every row a sum that cancels to about
    nothing, as dq where each query sees one key): the elementwise bound
    holds such a tensor alone."""
    out, want = out.float().flatten(0, -2), want.float().flatten(0, -2)
    norm = want.norm(dim=-1)
    median = float(norm.median())
    if median < tol * want.shape[-1] ** 0.5:
        return None
    return float(((out - want).norm(dim=-1) / norm.clamp(min=0.1 * median)).max())


def row_rel_err(out, want) -> float:
    """max over rows (every index but the last) of |out - want| / |want|,
    Euclidean norms."""
    out, want = out.float().flatten(0, -2), want.float().flatten(0, -2)
    return float(((out - want).norm(dim=-1) / want.norm(dim=-1)).max())


def time_ms(torch, fn, flush, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call.  The
    L2 cache is flushed before every call by ``flush()``, as the serving
    loop finds it (each layer's weights and cache slice evict the last
    layer's), and the stream is held busy while the host enqueues the call,
    so that the events time the device and not the host's launch
    overhead."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernels():
    """name -> wrapper of every kernel; each wrapper counts its launches."""
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.moe_gating import moe_gating, moe_router, moe_router_bwd
    from repro_torch.kernels.ssd_scan import ssd_state_scan, ssd_state_scan_bwd
    return {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
            "flash_decode": flash_decode, "moe_gating": moe_gating,
            "moe_router": moe_router, "moe_router_bwd": moe_router_bwd,
            "ssd_state_scan": ssd_state_scan, "ssd_state_scan_bwd": ssd_state_scan_bwd}


# wrapper -> a part of the name of every CUDA kernel it launches, as the
# profiler reports them
KERNEL_SYMBOLS = {
    "flash_attention": ("attention_bf16_kernel", "attention_f32_kernel"),
    "flash_attention_bwd": ("bwd_dot_kernel", "bwd_dkdv_sm90_kernel", "bwd_dq_sm90_kernel",
                            "bwd_dkdv_f32_kernel", "bwd_dq_f32_kernel"),
    "flash_decode": ("flash_decode_",),
    "moe_gating": ("moe_gating_kernel",),
    "moe_router": ("moe_router_kernel", "moe_router_decode_kernel"),
    "moe_router_bwd": ("moe_router_bwd_kernel",),
    "ssd_state_scan": ("ssd_scan_kernel",),
    "ssd_state_scan_bwd": ("ssd_scan_bwd_kernel",),
}


def router_chain(x, router, k):
    """The router as the port ran it before ``moe_router``: x cast to f32,
    the cuBLAS f32 product, the logits-input ``moe_gating`` kernel and the
    softmax of the load-balance statistics, four launches."""
    import torch
    from repro_torch.kernels.moe_gating import moe_gating
    logits = x.float() @ router
    w, ids = moe_gating(logits, k)
    return w, ids, torch.softmax(logits, dim=-1)


def in_span(torch, fn, name):
    """``fn`` run inside a profiler range ``name``: the device time of the
    kernels launched in it is read off that range."""
    def spanned(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)
    return spanned


def reset_launches() -> None:
    for fn in kernels().values():
        fn.launches = 0


def launches_now():
    return {name: fn.launches for name, fn in kernels().items()}


def bound_of(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ptxas_summary(log: str):
    """One line per compiled kernel from nvcc's ``--ptxas-options=-v``
    output: its name, registers, spill bytes and static shared memory;
    warnings as they are."""
    name, spills = None, "spills not reported"
    for line in log.splitlines():
        if "warning" in line:
            yield line.strip()
        elif m := re.search(r"Compiling entry function '(\w+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            smem = re.search(r"(\d+) bytes smem", line)
            yield (f"{demangle(name)}: {m.group(1)} registers, {spills}"
                   f"{f', {smem.group(1)} bytes static smem' if smem else ''}")
            name = None


def demangle(name: str) -> str:
    """``void ns::kernel<64>(args)`` -> ``kernel<64>``; the raw name without
    ``c++filt``."""
    try:
        full = subprocess.run(["c++filt", name], capture_output=True, text=True,
                              timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return name
    full = full.replace("(anonymous namespace)::", "")
    return full.split("(")[0].removeprefix("void ").split("::")[-1] or name


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

ATTN_CASES = [  # (B, Sq, Sk, H, K, hd, causal[, "strided"])
    (1, 1, 1, 16, 8, 128, True),
    (1, 17, 17, 16, 8, 128, True),
    (2, 200, 200, 16, 8, 128, True),
    (1, 1000, 1000, 16, 8, 128, True),
    (1, 17, 200, 16, 8, 128, True),       # Sq != Sk: queries are the last 17
    (1, 200, 1000, 14, 2, 64, True),
    (1, 1000, 1000, 14, 2, 64, True),
    (2, 200, 17, 16, 8, 128, False),
    (1, 1000, 1000, 14, 2, 64, False),
    (1, 700, 700, 32, 32, 80, True),       # zamba2's shared block, head dim 80
    (2, 17, 700, 32, 32, 80, True),
    (1, 150, 211, 32, 32, 80, True),       # head dim 80, ragged Sq and Sk tails
    (4, 300, 300, 32, 4, 128, True),       # qwen3-moe prefill, group 8
    # query counts around the 64-row tile; the causal diagonal on a tile
    # edge (Sk = Sq) and inside a key tile (Sk = Sq + 100)
    *((1, Sq, Sq + extra, 16, 8, 128, True) for Sq in (1, 63, 64, 65, 129)
      for extra in (0, 100)),
    # q a view with padded heads, k/v a layer of a stacked (2,B,S,K,hd) tensor
    (2, 140, 140, 8, 4, 128, True, "strided"),
    (2, 140, 140, 8, 4, 80, True, "strided"),
    # seamless (phase 13), head dim 64, group 1: an encoder layer (and the
    # cross-attention in training, Sq = Sk = 1024), the cross-attention of a
    # one-token prefill over 1024 frames, the decoder's causal
    # self-attention in training and in a one-token prefill
    (4, 1024, 1024, 16, 16, 64, False),
    (4, 1, 1024, 16, 16, 64, False),
    (4, 1024, 1024, 16, 16, 64, True),
    (4, 1, 1, 16, 16, 64, True),
]

BWD_CASES = [  # (B, Sq, Sk, H, K, hd, causal[, "strided"])
    (4, 1024, 1024, 16, 8, 128, True),     # phase 8's layer: qwen3-1.7b, group 2
    (1, 200, 200, 16, 8, 128, True),       # ragged: 3 tiles and 8 rows
    (1, 17, 200, 16, 8, 128, True),        # Sq < Sk: queries are the last 17
    (1, 150, 211, 32, 32, 80, True),       # head dim 80, group 1, ragged Sq and Sk
    (2, 300, 300, 32, 4, 128, True),       # group 8
    (2, 65, 130, 14, 2, 64, True),         # head dim 64, group 7
    (1, 65, 33, 16, 8, 128, False),
    # query counts around the 64-row tile; the diagonal on and inside a tile
    *((1, Sq, Sq + extra, 16, 8, 64, True) for Sq in (1, 63, 64, 65, 129)
      for extra in (0, 100)),
    # q and dO views with padded heads, k/v a layer of a stacked tensor
    (2, 140, 140, 8, 4, 128, True, "strided"),
    (2, 140, 140, 8, 4, 80, True, "strided"),
    # the wgmma kernels' tile edges at hd 128 and 80: Sq = Sk around one and
    # two 64-row tiles, causal and not; Sq != Sk across a tile edge
    *((1, S, S, 4, 2, hd, causal) for S in (63, 64, 65, 127, 128, 129) for hd in (128, 80)
      for causal in (True, False)),
    *((1, Sq, Sk, 4, 2, hd, causal) for Sq, Sk in ((63, 129), (65, 128), (127, 129), (64, 65))
      for hd in (128, 80) for causal in (True, False)),
    *((1, Sq, Sk, 4, 2, hd, False) for Sq, Sk in ((129, 63), (128, 65)) for hd in (128, 80)),
    # Sq % 4 != 0 with Sk > Sq: LSE and D rows that start off a 16-byte line
    (2, 65, 129, 8, 4, 128, True),
    (1, 17, 131, 8, 2, 80, True),
    (1, 127, 300, 16, 8, 128, True),
    (4, 200, 200, 32, 4, 128, True),       # group 8 at B = 4
    # strided q and dO at hd 80 through the tensor maps, ragged tiles
    (1, 129, 129, 8, 4, 80, True, "strided"),
    (2, 65, 130, 8, 4, 80, True, "strided"),
    # seamless's training layers (phase 13), group 1: the encoder's and the
    # cross-attention's (no mask), the decoder's self-attention (causal)
    (4, 1024, 1024, 16, 16, 64, False),
    (4, 1024, 1024, 16, 16, 64, True),
]

# f32 only, forward and backward: the edges of the f32 forward's 128-row
# blocks (128 positions of one head at odd groups, the 64 positions of two
# heads at even groups) and lidc-100m's training layer (phase 14)
F32_EDGE_CASES = [  # (B, Sq, Sk, H, K, hd, causal)
    *((1, S, S, 4, 4, hd, causal) for S in (127, 128, 129, 255, 256, 257)
      for hd in (64, 80, 128) for causal in (True, False)),
    *((1, S, S, 4, 2, 64, True) for S in (127, 128, 129, 255, 256, 257)),
    *((1, Sq, Sk, 4, 4, 64, causal) for Sq, Sk in ((127, 257), (129, 256), (255, 257),
                                                    (128, 129)) for causal in (True, False)),
    (1, 257, 129, 4, 4, 64, False),
    (2, 257, 257, 6, 2, 64, True),         # group 3: 128 positions of one head
    (4, 1024, 1024, 10, 5, 64, True),      # lidc-100m's layer, group 2
]

DECODE_CASES = [  # (B, Smax, H, K, hd, lengths[, "0-dim": one length as a 0-dim tensor])
    (8, 2048, 16, 8, 128, [1, 7, 64, 65, 1000, 1500, 2047, 2048]),
    (3, 300, 14, 2, 64, [1, 150, 300]),
    (2, 512, 16, 8, 128, 300),            # one scalar length for the batch
    (4, 1024, 32, 32, 80, [1, 300, 700, 1024]),   # zamba2, head dim 80, group 1
    (4, 1024, 32, 32, 80, 716),
    (4, 512, 32, 4, 128, [1, 64, 65, 308]),      # qwen3-moe, group 8
    (4, 512, 32, 4, 128, 308),
    (3, 700, 24, 8, 128, [1, 300, 700]),         # group 3 (phi4-mini)
    (2, 600, 48, 8, 128, [129, 600]),            # group 6 (grok)
    (3, 1000, 14, 2, 64, [64, 513, 1000]),       # group 7 at head dim 64 (qwen2)
    # lengths at tile and span edges, 0 (uniform over Smax), past Smax
    (11, 640, 16, 8, 128, [1, 63, 64, 65, 127, 128, 129, 639, 640, 0, 645]),
    (11, 640, 32, 32, 80, [1, 63, 64, 65, 127, 128, 129, 639, 640, 0, 645]),
    (11, 640, 8, 2, 64, [1, 63, 64, 65, 127, 128, 129, 639, 640, 0, 645]),   # split slots
    (11, 640, 4, 4, 80, [1, 63, 64, 65, 127, 128, 129, 639, 640, 0, 645]),
    (1, 8192, 16, 8, 128, [8192]),               # one slot: 4 spans, the ring wraps
    (1, 8192, 16, 8, 128, [5000]),
    (4, 2048, 16, 8, 128, [1, 2048, 1, 2048]),   # length 1 beside full slots
    (64, 1024, 16, 8, 128, [1024 - 13 * i for i in range(64)]),  # one block a slot
    # seamless (phase 13), head dim 64, group 1: the cross-attention's 0-dim
    # encoder length, per-slot lengths, and the self-attention's 0-dim
    # index + 1 over the 64-token cache
    (4, 1024, 16, 16, 64, 1024, "0-dim"),
    (4, 1024, 16, 16, 64, [1, 33, 500, 1024]),
    (4, 64, 16, 16, 64, 33, "0-dim"),
    # GQA groups above 8: mistral-large-123b's 96 query heads over 8 KV heads
    # (group 12, phase 17), and group 24 (two row blocks of 16, each reading
    # the cache)
    (4, 1024, 96, 8, 128, [1, 300, 1000, 1024]),
    (8, 2048, 96, 8, 128, 777),
    (3, 700, 48, 2, 128, [5, 64, 700]),
    (2, 300, 24, 1, 64, [1, 299]),
]

# the decode kernel's log-sum-exps against ``ref.decode_lse_ref`` (atol =
# rtol): f32 sums either way; in bf16 the kernel's scores come from bf16
# products on the tensor cores, as the output's do
LSE_TOL = 1e-3

GATING_CASES = [  # (T, E, k, tied logits)
    (4, 128, 8, False),                   # qwen3-moe decode, 4 slots
    (1200, 128, 8, False),                # qwen3-moe prefill, 4 x 300 tokens
    (300, 64, 6, False),
    (17, 8, 2, False),
    (1200, 128, 8, True),                 # rows rounded to one decimal, one constant row
]

ROUTER_CASES = [  # (T, D, E, k, x dtype, router columns repeated 8 times)
    (4, 2048, 128, 8, "bfloat16", False),      # qwen3-moe decode, 4 slots
    (1200, 2048, 128, 8, "bfloat16", False),   # qwen3-moe prefill, 4 x 300 tokens
    (4, 2048, 128, 8, "float32", False),
    (1200, 2048, 128, 8, "float32", False),
    (300, 2048, 64, 6, "bfloat16", False),
    (17, 6144, 8, 2, "bfloat16", False),       # grok-1's router, ragged T
    (33, 136, 256, 32, "float32", False),      # the widest E and k, a short last chunk
    (4, 2048, 128, 8, "bfloat16", True),       # exact ties: ids equal
    (1200, 2048, 128, 8, "bfloat16", True),
]

# the router backward: token rows from decode (1-9) to phase 10's prefill
# (4096), at qwen3-moe's D = 2048, E = 128, k = 8
ROUTER_BWD_ROWS = [1, 4, 8, 9, 1200, 4096]
ROUTER_OP_ROWS = [4, 1200, 4096]

SCAN_CASES = [(1, 3, 64, 80, 64), (2, 5, 4, 16, 16)]   # (B, C, H, P, N)
SCAN_BWD_CASES = [  # (B, C, H, P, N)
    (4, 4, 64, 80, 64),     # phase 11's Mamba2 block: zamba2-2.7b, 4 x 1024 tokens
    (2, 5, 4, 16, 16),
    (1, 1, 2, 8, 8),        # one chunk
    (3, 3, 5, 7, 9),        # P*N = 63: the kernel's 4-byte path
    (1, 6, 2, 80, 65),      # P*N = 5200: a cluster of eight blocks, the last run ragged
]


def check_kernels(torch, dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for dtype_name in ("float32", "bfloat16"):
        dtype, tol = getattr(torch, dtype_name), TOL[dtype_name]
        edges = F32_EDGE_CASES if dtype_name == "float32" else []
        for B, Sq, Sk, H, K, hd, causal, *strided in ATTN_CASES + edges:
            if strided:
                q = randn((B, Sq, H, hd + 8), dtype)[..., :hd]
                k, v = (randn((2, B, Sk, K, hd), dtype)[1] for _ in range(2))
            else:
                q = randn((B, Sq, H, hd), dtype)
                k, v = randn((B, Sk, K, hd), dtype), randn((B, Sk, K, hd), dtype)
            err, ok = max_err(flash_attention(q, k, v, causal=causal),
                              ref.attention_ref(q, k, v, causal=causal), tol)
            torch.cuda.synchronize()
            print(f"  flash_attention {dtype_name} B={B} Sq={Sq} Sk={Sk} H={H} K={K} "
                  f"hd={hd} causal={causal}{' strided' if strided else ''}: "
                  f"max_abs_err={err:.3e} (tol {tol})")
            check(ok, f"flash_attention disagrees with attention_ref: {err}")
        for B, Smax, H, K, hd, lengths, *form in DECODE_CASES:
            q = randn((B, 1, H, hd), dtype)
            # a layer of a stacked (L, B, Smax, K, hd) cache, read in place
            ck = randn((2, B, Smax, K, hd), dtype)[1]
            cv = randn((2, B, Smax, K, hd), dtype)[1]
            length = (torch.tensor(lengths, dtype=torch.int32, device=dev)
                      if isinstance(lengths, list) or form else lengths)
            out = flash_decode(q, ck, cv, length)
            want = ref.decode_attention_ref(q, ck, cv, length)
            err, ok = max_err(out, want, tol)
            rel, rel_tol = row_rel_err(out, want), DECODE_REL_TOL[dtype_name]
            torch.cuda.synchronize()
            print(f"  flash_decode {dtype_name} B={B} Smax={Smax} H={H} K={K} hd={hd} "
                  f"lengths={lengths}{' (0-dim)' if form else ''}: max_abs_err={err:.3e} "
                  f"(tol {tol}), "
                  f"row_rel_err={rel:.3e} (tol {rel_tol})")
            check(ok, f"flash_decode disagrees with decode_attention_ref: {err}")
            check(rel <= rel_tol, f"flash_decode rows off decode_attention_ref: {rel}")
            # the same launch with the log-sum-exps (the sharded decode's
            # merge over position shards): the output unchanged, the lse
            # against the plain version's
            out_l, lse = flash_decode(q, ck, cv, length, with_lse=True)
            lerr, lok = max_err(lse, ref.decode_lse_ref(q, ck, length), LSE_TOL)
            torch.cuda.synchronize()
            print(f"    with_lse: output bit-equal {torch.equal(out_l, out)}, lse "
                  f"max_abs_err={lerr:.3e} (tol {LSE_TOL})")
            check(torch.equal(out_l, out), "flash_decode with_lse changed the output")
            check(lok, f"flash_decode lse disagrees with decode_lse_ref: {lerr}")
    check_attention_bwd(torch, dev, gen)
    check_moe_gating(torch, dev, gen)
    check_moe_router(torch, dev, gen)
    check_moe_router_bwd(torch, dev, gen)
    check_ssd_scan(torch, dev, gen)
    check_ssd_scan_bwd(torch, dev, gen)


def check_attention_bwd(torch, dev, gen):
    """The backward kernel against ``ref.attention_bwd_ref`` (f32, from the
    same inputs), from the forward kernel's own output and log-sum-exp; the
    log-sum-exp against ``ref.attention_lse_ref``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    for dtype_name in ("float32", "bfloat16"):
        dtype, tol = getattr(torch, dtype_name), TOL[dtype_name]

        def randn(shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        edges = F32_EDGE_CASES if dtype_name == "float32" else []
        for B, Sq, Sk, H, K, hd, causal, *strided in BWD_CASES + edges:
            if strided:
                q, do = randn((B, Sq, H, hd + 8))[..., :hd], randn((B, Sq, H, hd + 8))[..., :hd]
                k, v = randn((2, B, Sk, K, hd))[1], randn((2, B, Sk, K, hd))[1]
            else:
                q, k, v = randn((B, Sq, H, hd)), randn((B, Sk, K, hd)), randn((B, Sk, K, hd))
                do = randn((B, Sq, H, hd))
            o, lse = flash_attention_fwd(q, k, v, causal=causal, with_lse=True)
            err_l, ok_l = max_err(lse, ref.attention_lse_ref(q, k, causal=causal), tol)
            got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
            want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
            torch.cuda.synchronize()
            errs = [max_err(g, w, tol) for g, w in zip(got, want)]
            rels = [grad_row_rel_err(g, w, tol) for g, w in zip(got, want)]
            print(f"  flash_attention_bwd {dtype_name} B={B} Sq={Sq} Sk={Sk} H={H} K={K} "
                  f"hd={hd} causal={causal}{' strided' if strided else ''}: max_abs_err "
                  f"dq/dk/dv={'/'.join(f'{e:.3e}' for e, _ in errs)} (tol {tol}), "
                  f"row_rel_err={'/'.join('n/a' if r is None else f'{r:.3e}' for r in rels)} "
                  f"(tol {GRAD_ROW_TOL[dtype_name]}); lse max_abs_err={err_l:.3e}")
            check(ok_l, f"the forward's lse disagrees with attention_lse_ref: {err_l}")
            check(all(ok for _, ok in errs), f"flash_attention_bwd disagrees with "
                                             f"attention_bwd_ref: {errs}")
            check(all(r is None or r <= GRAD_ROW_TOL[dtype_name] for r in rels),
                  f"flash_attention_bwd rows off attention_bwd_ref: {rels}")


def gating_logits(torch, gen, dev, T, E, tied):
    x = torch.randn((T, E), generator=gen, device=dev)
    if tied:
        x = torch.round(x * 10) / 10
        x[0] = 0.5
    return x


def check_moe_gating(torch, dev, gen):
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_gating import moe_gating
    for T, E, k, tied in GATING_CASES:
        x = gating_logits(torch, gen, dev, T, E, tied)
        w, ids = moe_gating(x, k)
        want_w, want_ids = ref.moe_gating_ref(x, k)
        torch.cuda.synchronize()
        same = bool(torch.equal(ids, want_ids))
        err, ok = max_err(w, want_w, TOL["float32"])
        print(f"  moe_gating T={T} E={E} k={k} tied={tied}: ids equal={same}, "
              f"weights max_abs_err={err:.3e} (tol {TOL['float32']})")
        check(same, f"moe_gating ids differ from moe_gating_ref at T={T} E={E} k={k}")
        check(ok, f"moe_gating weights disagree with moe_gating_ref: {err}")


def router_inputs(torch, gen, dev, T, D, E, dtype, dup):
    """x (T,D) and the f32 router (D,E) at the model's scale (logits of about
    unit size); ``dup`` repeats E//8 distinct columns 8 times, so both paths
    see bitwise-equal logits within a group."""
    x = torch.randn((T, D), generator=gen, device=dev).to(getattr(torch, dtype))
    router = torch.randn((D, E if not dup else E // 8), generator=gen, device=dev) * D ** -0.5
    if dup:
        router = router.repeat_interleave(8, dim=1)
    return x, router.contiguous()


def router_agreement(out, want):
    """(rows whose ids differ, largest |plain probability of the kernel's
    expert - plain probability of the plain choice| over every rank, largest
    |d log p|), the last standing for |d logit|: a logit's error less its
    row's log-sum-exp error."""
    (w, ids, probs), (want_w, want_ids, want_probs) = out, want
    gap = (want_probs.gather(1, ids.long()) - want_probs.gather(1, want_ids.long())).abs()
    dlogp = (probs.log() - want_probs.log()).abs()
    return int((ids != want_ids).any(dim=1).sum()), float(gap.max()), float(dlogp.max())


def check_router_output(torch, out, want, E, exact_ids):
    """The checks of phase 2 on one ``moe_router`` call against its plain
    version; returns the readings it prints."""
    (w, ids, probs), (want_w, want_ids, want_probs) = out, want
    err_w, ok_w = max_err(w, want_w, TOL["float32"])
    err_p, ok_p = max_err(probs, want_probs, TOL["float32"])
    srt = ids.sort(dim=1).values
    well_formed = bool((ids >= 0).all() and (ids < E).all()
                       and (srt[:, 1:] > srt[:, :-1]).all())
    rows, gap, dlogp = router_agreement(out, want)
    ok_ids = torch.equal(ids, want_ids) if exact_ids else gap <= ROUTER_TIE_DELTA
    return {"ok": ok_w and ok_p and well_formed and ok_ids, "err_w": err_w, "err_p": err_p,
            "rows_differ": rows, "gap": gap, "dlogp": dlogp}


def check_moe_router(torch, dev, gen):
    from repro_torch.kernels import ref
    from repro_torch.kernels.moe_gating import moe_router
    worst = 0.0
    for T, D, E, k, dtype, dup in ROUTER_CASES:
        x, router = router_inputs(torch, gen, dev, T, D, E, dtype, dup)
        r = check_router_output(torch, moe_router(x, router, k),
                                ref.moe_router_ref(x, router, k), E, exact_ids=dup)
        torch.cuda.synchronize()
        worst = max(worst, r["dlogp"])
        print(f"  moe_router T={T} D={D} E={E} k={k} x {dtype}"
              f"{' repeated columns' if dup else ''}: rows with other ids {r['rows_differ']}"
              f", max |d log p| {r['dlogp']:.3e}, max prob gap at a rank {r['gap']:.3e} "
              f"({'ids equal required' if dup else f'delta {ROUTER_TIE_DELTA}'}), "
              f"max_abs_err weights {r['err_w']:.3e} probs {r['err_p']:.3e} "
              f"(tol {TOL['float32']})")
        check(r["ok"], f"moe_router disagrees with moe_router_ref at T={T} D={D} E={E}: {r}")
    print(f"  moe_router: largest |d log p| {worst:.3e}; delta {ROUTER_TIE_DELTA} is "
          f"{ROUTER_TIE_DELTA / max(worst, 1e-30):.1f}x it")
    check(ROUTER_TIE_DELTA >= 10 * worst, "moe_router's logits moved by more than delta / 10")


def pinned_router(torch, x, router, ids):
    """The plain router's weights and probabilities with the routing taken
    from ``ids``, differentiable in x and the router: the kernel sums the
    logits in another order than cuBLAS, so near ties may route otherwise,
    and a gradient is compared where the routing is the same."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    s = probs.gather(1, ids.long())
    return s / s.sum(dim=1, keepdim=True), probs


def grads_close(got, want, dtypes):
    """(largest elementwise err, largest row-relative err or None, within
    both tolerances) over gradient pairs, each at the tolerance of its
    dtype name."""
    errs, rels, ok = [], [], True
    for g, w, dtype in zip(got, want, dtypes):
        err, ok_e = max_err(g, w, TOL[dtype])
        rel = grad_row_rel_err(g, w, TOL[dtype])
        errs.append(err)
        rels.append(rel)
        ok = ok and ok_e and (rel is None or rel <= GRAD_ROW_TOL[dtype])
    return errs, rels, ok


def check_moe_router_bwd(torch, dev, gen):
    """The router backward against ``ref.moe_router_bwd_ref`` on the
    forward kernel's own outputs, gprobs present and absent, router columns
    distinct and repeated (probabilities that tie exactly); then the
    registered op's dx and drouter against autograd through the plain
    router with the kernel's routing."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.moe_gating import moe_router_bwd, moe_router_fwd
    D, E, k = 2048, 128, 8
    for T in ROUTER_BWD_ROWS:
        for dup in (False, True):
            x, router = router_inputs(torch, gen, dev, T, D, E, "bfloat16", dup)
            w, ids, probs = moe_router_fwd(x, router, k)
            gw = torch.randn((T, k), generator=gen, device=dev)
            gprobs = torch.randn((T, E), generator=gen, device=dev)
            for gp in (gprobs, None):
                got = moe_router_bwd(gw, gp, w, ids, probs)
                want = ref.moe_router_bwd_ref(gw, gp, w, ids, probs)
                torch.cuda.synchronize()
                (err,), (rel,), ok = grads_close([got], [want], ["float32"])
                print(f"  moe_router_bwd T={T} E={E} k={k}{' repeated columns' if dup else ''}"
                      f" gprobs {'present' if gp is not None else 'absent'}: max_abs_err "
                      f"{err:.3e} (tol {TOL['float32']}), row_rel_err "
                      f"{'n/a' if rel is None else f'{rel:.3e}'} "
                      f"(tol {GRAD_ROW_TOL['float32']})")
                check(ok, f"moe_router_bwd disagrees with moe_router_bwd_ref at T={T}: {err}")
    for T in ROUTER_OP_ROWS:
        for dtype in ("float32", "bfloat16"):
            x, router = router_inputs(torch, gen, dev, T, D, E, dtype, False)
            gw = torch.randn((T, k), generator=gen, device=dev)
            gprobs = torch.randn((T, E), generator=gen, device=dev) / T
            leaves = [x.clone().requires_grad_(), router.clone().requires_grad_()]
            w, ids, probs = ops.moe_router(*leaves, k)
            got = torch.autograd.grad([w, probs], leaves, [gw, gprobs])
            plain = [x.clone().requires_grad_(), router.clone().requires_grad_()]
            want = torch.autograd.grad(pinned_router(torch, *plain, ids), plain, [gw, gprobs])
            torch.cuda.synchronize()
            errs, rels, ok = grads_close(got, want, [dtype, "float32"])
            print(f"  repro_torch::moe_router gradient T={T} D={D} E={E} k={k} x {dtype}: "
                  f"max_abs_err dx/drouter={errs[0]:.3e}/{errs[1]:.3e} (tol {TOL[dtype]}/"
                  f"{TOL['float32']}), row_rel_err "
                  f"{'/'.join('n/a' if r is None else f'{r:.3e}' for r in rels)}")
            check(ok and got[0].dtype == x.dtype, f"the router op's gradients disagree with "
                                                  f"the plain router's at T={T} {dtype}")


def check_ssd_scan(torch, dev, gen):
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_state_scan
    for B, C, H, P, N in SCAN_CASES:
        xs = torch.randn((B, C, H, P, N), generator=gen, device=dev)
        a = torch.rand((B, C, H), generator=gen, device=dev) * 0.69 + 0.3
        for s0 in (None, torch.randn((B, H, P, N), generator=gen, device=dev)):
            prefix, final = ssd_state_scan(xs, a, s0)
            want_prefix, want_final = ref.ssd_state_scan_ref(xs, a, s0)
            torch.cuda.synchronize()
            err_p, ok_p = max_err(prefix, want_prefix, TOL["float32"])
            err_f, ok_f = max_err(final, want_final, TOL["float32"])
            print(f"  ssd_state_scan B={B} C={C} H={H} P={P} N={N} "
                  f"init={s0 is not None}: max_abs_err prefix={err_p:.3e} "
                  f"final={err_f:.3e} (tol {TOL['float32']})")
            check(ok_p and ok_f, f"ssd_state_scan disagrees with ssd_state_scan_ref: "
                                 f"{err_p} / {err_f}")


def scan_bwd_close(got, want, prefix, tol=TOL["float32"]):
    """(largest elementwise err, within tolerance) of the reverse scan's
    (d_states, d_decays, d_init) against ``want``: d_states and d_init
    elementwise at ``tol``; each d_decays[b, c, h], a sum of P*N products
    G * prefix[c] taken in another order (its rounding grows as the
    products' Euclidean norm, ~3e-5 at zamba2's 5120 products of size ~2),
    also within ``tol`` of that norm."""
    errs, ok = [], True
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        if (g is None) != (w is None):
            return float("inf"), False
        if g is not None:
            err, ok_e = max_err(g, w, tol)
            errs.append(err)
            ok = ok and ok_e
    scale = (want[0].float() * prefix.float()).flatten(3).norm(dim=-1)
    err = (got[1].float() - want[1].float()).abs()
    errs.append(float(err.max()))
    return max(errs), ok and bool((err <= tol + tol * want[1].abs() + tol * scale).all())


def autograd_scan(torch, leaves, g_prefix, g_final):
    """Autograd's (d_states, d_decays, d_init or None) through the plain
    scan from the cotangents (None: nothing reads that output); zeros where
    no path leads to a leaf (one chunk and no initial state: a constant
    prefix)."""
    from repro_torch.kernels import ref
    outs = ref.ssd_state_scan_ref(*leaves)
    dot = sum((o * g).sum() for o, g in zip(outs, (g_prefix, g_final)) if g is not None)
    grads = (torch.autograd.grad(dot, leaves, allow_unused=True) if dot.requires_grad
             else [None] * len(leaves))
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    return grads[0], grads[1], grads[2] if len(grads) == 3 else None


def check_ssd_scan_bwd(torch, dev, gen):
    """The reverse scan against ``ref.ssd_state_scan_bwd_ref`` and autograd
    through the plain scan, from the forward kernel's prefix, with and
    without an initial state and the final state's gradient, and bit-equal
    when run twice; then the registered op's gradients (through
    ``ops.ssd_state_scan``) against autograd through the plain scan."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ssd_scan import ssd_state_scan_bwd, ssd_state_scan_fwd

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def decays(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 0.69 + 0.3

    for B, C, H, P, N in SCAN_BWD_CASES:
        xs, a, gp = randn(B, C, H, P, N), decays(B, C, H), randn(B, C, H, P, N)
        for s0 in (None, randn(B, H, P, N)):
            prefix, _ = ssd_state_scan_fwd(xs, a, s0)
            for gf in (None, randn(B, H, P, N)):
                has_init = s0 is not None
                got = ssd_state_scan_bwd(gp, gf, prefix, a, has_init)
                same = all(g is None or torch.equal(g, h) for g, h in
                           zip(got, ssd_state_scan_bwd(gp, gf, prefix, a, has_init)))
                want = ref.ssd_state_scan_bwd_ref(gp, gf, prefix, a, has_init)
                leaves = [t.clone().requires_grad_() for t in (xs, a, s0) if t is not None]
                auto = autograd_scan(torch, leaves, gp, gf)
                torch.cuda.synchronize()
                err, ok = scan_bwd_close(got, want, prefix)
                err_a, ok_a = scan_bwd_close(got, auto, prefix)
                print(f"  ssd_state_scan_bwd B={B} C={C} H={H} P={P} N={N} init={has_init} "
                      f"g_final={gf is not None}: max_abs_err vs closed form {err:.3e}, vs "
                      f"autograd {err_a:.3e} (tol {TOL['float32']}; d_decays also "
                      f"{TOL['float32']} x its products' norm); run twice bit-equal {same}")
                check(ok and ok_a and same, f"ssd_state_scan_bwd disagrees with its plain "
                                            f"versions or repeats otherwise at {(B, C, H, P, N)}")
    for B, C, H, P, N in SCAN_BWD_CASES[:2]:
        xs, a, s0 = randn(B, C, H, P, N), decays(B, C, H), randn(B, H, P, N)
        gp, gf = randn(B, C, H, P, N), randn(B, H, P, N)
        leaves = [t.clone().requires_grad_() for t in (xs, a, s0)]
        prefix, final = ops.ssd_state_scan(*leaves)
        got = torch.autograd.grad([prefix, final], leaves, [gp, gf])
        auto = autograd_scan(torch, [t.clone().requires_grad_() for t in (xs, a, s0)], gp, gf)
        torch.cuda.synchronize()
        err, ok = scan_bwd_close(got, auto, prefix.detach())
        print(f"  repro_torch::ssd_state_scan gradient B={B} C={C} H={H} P={P} N={N}: "
              f"max_abs_err vs autograd through the plain scan {err:.3e}")
        check(ok, f"the scan op's gradients disagree with the plain scan's at {(B, C, H, P, N)}")


# ---------------------------------------------------------------------------
# phase 3: serve qwen3-1.7b
# ---------------------------------------------------------------------------

def serve(torch, np, dev, cfg, params):
    from repro_torch.serve.engine import ServeEngine

    # warm-up on a small engine: cuBLAS handles, allocator, first launches
    warm = ServeEngine(cfg, params, max_batch=1, max_seq=64, device=dev)
    warm.submit([1, 2, 3, 4], max_new=3)
    warm.run()
    del warm

    rng = np.random.default_rng(0)
    lengths = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, N_REQUESTS)
    priorities = rng.integers(0, 3, N_REQUESTS)
    eng = ServeEngine(cfg, params, max_batch=MAX_BATCH, max_seq=MAX_SEQ, device=dev)
    reqs = [eng.submit(rng.integers(0, cfg.vocab, n).tolist(), max_new=MAX_NEW,
                       priority=int(p)) for n, p in zip(lengths, priorities)]
    reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launches_now()

    check(len(done) == N_REQUESTS and all(r.done for r in reqs),
          f"{len(done)} of {N_REQUESTS} requests finished")
    check(all(len(r.out) == MAX_NEW for r in reqs), "a request stopped short")
    check(all(0 <= t < cfg.vocab for r in reqs for t in r.out), "token out of range")
    for name in ("flash_attention", "flash_decode"):
        check(launches[name] > 0, f"{name} was not launched on the serving path")
    check(launches["moe_gating"] == launches["moe_router"] == launches["ssd_state_scan"] == 0,
          "a MoE or SSD kernel launched on the dense path")
    check(launches["flash_attention"] == N_REQUESTS * cfg.n_layers,
          f"flash_attention launches {launches['flash_attention']} != "
          f"{N_REQUESTS} prefills x {cfg.n_layers} layers")
    check(launches["flash_decode"] == eng.decode_steps * cfg.n_layers,
          f"flash_decode launches {launches['flash_decode']} != "
          f"{eng.decode_steps} steps x {cfg.n_layers} layers")

    ttft = sorted(r.first_token_at - r.submitted_at for r in reqs)
    decode_tokens = eng.tokens_out - N_REQUESTS
    print(f"  requests={len(done)} prompt_tokens={int(lengths.sum())} "
          f"tokens_out={eng.tokens_out} decode_steps={eng.decode_steps} "
          f"wall_s={wall:.3f}")
    print(f"  ttft_s p50={statistics.median(ttft):.4f} max={ttft[-1]:.4f} "
          f"(queueing for a slot included)")
    print(f"  prefill_s={eng.prefill_s:.3f} "
          f"prefill_tok_s={lengths.sum() / eng.prefill_s:.1f} "
          f"decode_s={eng.decode_s:.3f} decode_tok_s={decode_tokens / eng.decode_s:.1f} "
          f"ms_per_decode_step={1e3 * eng.decode_s / eng.decode_steps:.2f}")
    print(f"  launches: {launches}")
    served_us = profile_decode(torch, np, cfg, eng)
    prompt_fills_cache(torch, np, cfg, eng)
    return launches, [int(n) for n in lengths], served_us


def profile_decode(torch, np, cfg, eng):
    """Where a decode step's time goes, 8 slots busy at 512-token prompts."""
    rng = np.random.default_rng(2)
    for _ in range(MAX_BATCH):
        eng.submit(rng.integers(0, cfg.vocab, PROFILE_PROMPT).tolist(), max_new=16)
    eng._admit()
    eng.step()
    served_us = profile_steps(torch, eng.step,
                              f"decode step (8 slots, ~{PROFILE_PROMPT + 8} positions)")
    eng.run()
    return served_us


def prompt_fills_cache(torch, np, cfg, eng):
    """A prompt of exactly max_seq tokens leaves no cache position for the
    next token's key: it must finish at prefill with one token, and the
    device must stay usable (an out-of-range cache write would be a
    device-side assert, which ends the process's CUDA context)."""
    rng = np.random.default_rng(4)
    steps = eng.decode_steps
    req = eng.submit(rng.integers(0, cfg.vocab, MAX_SEQ).tolist(), max_new=MAX_NEW)
    done = eng.run()
    torch.cuda.synchronize()
    check(done == [req] and req.done and len(req.out) == 1 and eng.decode_steps == steps,
          f"a {MAX_SEQ}-token prompt gave {len(req.out)} tokens over "
          f"{eng.decode_steps - steps} decode steps")
    check(all(s is None for s in eng.slots) and int(eng.cache["index"].abs().sum()) == 0,
          "the max_seq prompt left its slot busy")
    after = eng.submit([1, 2, 3], max_new=2)
    eng.run()
    torch.cuda.synchronize()
    check(after.done and len(after.out) == 2, "the engine stopped serving after it")
    print(f"  a {MAX_SEQ}-token prompt (max_seq): finished at prefill with 1 token, "
          f"no decode step; the next request served")


def profile_steps(torch, step, label, spans=(), n=PROFILE_STEPS, host_ops=True):
    """Host time per call of ``step`` over ``n`` calls, then device
    time per call by kernel from a torch.profiler window over as many more
    (sum of kernel durations; one stream, so they do not overlap), and the
    device's idle share of the unprofiled call.  Returns the host and the
    device busy ms per call ("host_ms", "busy_ms"), the device us per call
    of each wrapper's kernels (KERNEL_SYMBOLS) and of each profiler
    range named in ``spans``: the kernels that ran inside the range's
    device-side interval (first to last kernel launched in it; one stream,
    so no other kernel runs there).  ``host_ops=False`` traces the device
    alone (no ranges then): reading a trace of ~10^5 launches a step with
    its host ops takes minutes."""
    import bisect
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / n
    by_name, ranges, ran = {}, {name: [] for name in spans}, []
    try:
        activities = [ProfilerActivity.CPU] * host_ops + [ProfilerActivity.CUDA]
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        for name, start, end in device_events(prof):
            if name in ranges:        # a range's device side, not a kernel
                ranges[name].append((start, end))
            else:
                by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
                ran.append((start, end))
    except RuntimeError as exc:       # a diagnostic: the profiler may be unavailable
        print(f"  torch.profiler failed ({exc}); device time not measured")
    span_us = {}
    for name, intervals in ranges.items():
        intervals.sort()
        starts = [a for a, _ in intervals]
        inside = 0.0
        for start, end in ran:
            i = bisect.bisect_right(starts, start) - 1
            if i >= 0 and end <= intervals[i][1]:
                inside += end - start
        span_us[name] = inside / n
    busy_ms = sum(by_name.values())
    busy_step = busy_ms / n
    print(f"  {label}: {step_ms:.2f} ms host clock; device busy {busy_step:.2f} ms/step, "
          f"idle share {1 - busy_step / step_ms:.3f} (profiled window "
          f"{wall_ms / n:.2f} ms/step)" if busy_ms else
          f"  {label}: {step_ms:.2f} ms host clock; profiler saw no device time")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {ms / n:8.3f} ms/step  {name[:100]}")
    kernel_us = {w: 1e3 / n * sum(ms for name, ms in by_name.items()
                                              if any(sym in name for sym in syms))
                 for w, syms in KERNEL_SYMBOLS.items()}
    print(f"  repo kernels, device us per step: "
          f"{ {w: round(us, 2) for w, us in kernel_us.items()} }")
    for w, syms in KERNEL_SYMBOLS.items():
        parts = {sym: 1e3 / n * sum(ms for name, ms in by_name.items() if sym in name)
                 for sym in syms}
        if sum(us > 0 for us in parts.values()) > 1:
            print(f"    {w} by kernel, device us per step: "
                  f"{ {sym: round(us, 2) for sym, us in parts.items() if us > 0} }")
    for name, us in span_us.items():
        print(f"  range {name!r}: device {us:.2f} us per step" if us else
              f"  range {name!r}: device time not measured (no kernel ran inside it)")
    return {**kernel_us, **span_us, "host_ms": step_ms, "busy_ms": busy_step}


# ---------------------------------------------------------------------------
# phases 5 and 6: serve zamba2-2.7b and qwen3-moe-30b-a3b through the serve
# steps (the entry point the JAX package serves these families through)
# ---------------------------------------------------------------------------

def serve_steps(torch, np, dev, cfg, params, batch, prompt_len, max_seq, steps,
                want_prefill, want_step, routers=False, frames=None):
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens (over
    ``frames`` (batch, F, D) for the encoder-decoder), then ``steps`` greedy
    decode steps.  ``want_prefill`` / ``want_step`` give each kernel's
    expected launches per prefill / per decode step.  With ``routers`` the
    profiled step runs the router in a profiler range, once through
    ``moe_router`` and once through ``router_chain``.  Returns the launches
    {"prefill": ..., "decode": ...}, ms per decode step and the device us
    per step of each kernel ("served") and of each router ("router")."""
    from repro_torch.train.step import make_prefill, make_serve_step
    prefill, serve_step = make_prefill(cfg), make_serve_step(cfg)

    def inputs(tokens, fr):
        return {"tokens": tokens} if fr is None else {"frames": fr, "tokens": tokens}

    # warm-up at a small size: cuBLAS handles, allocator, first launches
    warm = torch.ones((batch, 16 if frames is None else 1), dtype=torch.int32, device=dev)
    _, cache = prefill(params, inputs(warm, None if frames is None else frames[:, :16]),
                       max_seq=32)
    serve_step(params, cache, warm[:, :1])
    del cache
    torch.cuda.synchronize()

    rng = np.random.default_rng(3)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (batch, prompt_len)), dtype=torch.int32,
                        device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(params, inputs(toks, frames), max_seq=max_seq)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    at_prefill = launches_now()
    check(tuple(logits.shape) == (batch, 1, cfg.vocab), f"prefill logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")

    reset_launches()
    nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    out = [nxt]
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = serve_step(params, cache, nxt)
        nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        out.append(nxt)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    at_decode = launches_now()
    check(bool(torch.isfinite(logits).all()), "non-finite decode logits")
    out = torch.cat(out, dim=1)
    check(bool(((out >= 0) & (out < cfg.vocab)).all()), "token out of range")
    check(int(cache["index"]) == prompt_len + steps, f"cache index {int(cache['index'])}")

    ms_step = 1e3 * decode_s / steps
    print(f"  batch={batch} prompt={prompt_len} max_seq={max_seq} steps={steps}: "
          f"prefill_ms={1e3 * prefill_s:.1f} "
          f"prefill_tok_s={batch * prompt_len / prefill_s:.1f} "
          f"ms_per_decode_step={ms_step:.2f} decode_tok_s={batch * steps / decode_s:.1f}")
    print(f"  launches per prefill: {at_prefill}")
    print(f"  launches over {steps} decode steps: {at_decode}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  greedy tokens of slot 0: {out[0].tolist()}")
    for name in kernels():
        check(at_prefill[name] == want_prefill.get(name, 0),
              f"{name}: {at_prefill[name]} launches per prefill, expected "
              f"{want_prefill.get(name, 0)}")
        check(at_decode[name] == steps * want_step.get(name, 0),
              f"{name}: {at_decode[name]} launches over {steps} steps, expected "
              f"{steps} x {want_step.get(name, 0)}")

    def one_step():
        nonlocal cache, nxt
        logits, cache = serve_step(params, cache, nxt)
        nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)

    label = f"decode step ({batch} slots, ~{prompt_len + steps} positions)"
    if not routers:
        served = profile_steps(torch, one_step, label)
        del cache, logits
        return {"prefill": at_prefill, "decode": at_decode, "ms_per_step": ms_step,
                "served": served, "prefill_s": prefill_s}
    from repro_torch.kernels import ops
    windows = {}
    for name, fn in (("moe_router", ops.moe_router), ("router_chain", router_chain)):
        with mock.patch.object(ops, "moe_router", in_span(torch, fn, "router")):
            print(f"  router through {name}:")
            windows[name] = profile_steps(torch, one_step, label, spans=("router",))
    router_us = {name: us.pop("router") for name, us in windows.items()}
    served = windows["moe_router"]
    print(f"  router device us per decode step: moe_router {router_us['moe_router']:.2f}, "
          f"the chain it replaced {router_us['router_chain']:.2f}")
    del cache, logits
    return {"prefill": at_prefill, "decode": at_decode, "ms_per_step": ms_step,
            "served": served, "router": router_us}


def serve_hybrid(torch, np, dev):
    from repro_torch.configs.base import get_config
    from repro_torch.models import bundle_for, param_count
    arch, B, S, max_seq, steps = HYBRID_RUN
    cfg = get_config(arch)
    n_attn = cfg.n_layers // cfg.attn_every
    t0 = time.perf_counter()
    params = bundle_for(cfg).init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n = param_count(cfg)
    print(f"  {n / 1e9:.3f} B params ({2 * n / 2**30:.2f} GiB bf16), {cfg.n_layers} Mamba2 "
          f"blocks, {n_attn} shared-attention applications (head dim {cfg.hd}), "
          f"d_model {cfg.d_model}, init {time.perf_counter() - t0:.1f} s")
    run = serve_steps(torch, np, dev, cfg, params, B, S, max_seq, steps,
                      {"flash_attention": n_attn, "ssd_state_scan": cfg.n_layers},
                      {"flash_decode": n_attn})
    print("  teacher-forced logits, kernel path vs plain path")
    teacher_forced(torch, np, cfg, params)
    del params
    return run


def serve_mistral(torch, np, dev):
    """mistral-large-123b at full width and MISTRAL_RUN's depth through the
    serve steps (``transformer.prefill`` and ``decode_step``): group 12 on
    every decode launch; then the teacher-forced gap, as phase 4."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import bundle_for, param_count
    arch, layers, B, S, max_seq, steps = MISTRAL_RUN
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    t0 = time.perf_counter()
    params = bundle_for(cfg).init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n = param_count(cfg)
    print(f"  {n / 1e9:.3f} B params ({2 * n / 2**30:.2f} GiB bf16), {cfg.n_layers} of "
          f"{get_config(arch).n_layers} layers, {cfg.n_heads} query heads over "
          f"{cfg.n_kv_heads} KV heads (group {cfg.n_heads // cfg.n_kv_heads}) of {cfg.hd}, "
          f"d_model {cfg.d_model}, init {time.perf_counter() - t0:.1f} s")
    run = serve_steps(torch, np, dev, cfg, params, B, S, max_seq, steps,
                      {"flash_attention": cfg.n_layers}, {"flash_decode": cfg.n_layers})
    print("  teacher-forced logits, kernel path vs plain path")
    teacher_forced(torch, np, cfg, params)
    del params
    return run


def serve_moe(torch, np, dev):
    from repro_torch.configs.base import get_config
    from repro_torch.models import bundle_for, param_count
    arch, B, S, max_seq, steps = MOE_RUN
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = bundle_for(cfg).init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n = param_count(cfg)
    expert_bytes = 2.0 * 3 * cfg.n_experts * cfg.d_model * cfg.d_ff * cfg.n_layers
    print(f"  {n / 1e9:.3f} B params ({2 * n / 2**30:.2f} GiB bf16; "
          f"{param_count(cfg, active_only=True) / 1e9:.3f} B active), {cfg.n_layers} layers, "
          f"{cfg.n_experts} experts top-{cfg.top_k}, d_model {cfg.d_model}, "
          f"init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    run = serve_steps(torch, np, dev, cfg, params, B, S, max_seq, steps,
                      {"flash_attention": cfg.n_layers, "moe_router": cfg.n_layers},
                      {"flash_decode": cfg.n_layers, "moe_router": cfg.n_layers}, routers=True)
    floor_ms = expert_bytes / PEAK_BYTES * 1e3
    print(f"  every decode step multiplies all {cfg.n_experts} experts of every layer: "
          f"{expert_bytes / 1e9:.2f} GB of expert weights, at least {floor_ms:.2f} ms at "
          f"{PEAK_BYTES / 1e12:.2f} TB/s; measured {run['ms_per_step']:.2f} ms per step")
    del params
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(cfg, n_layers=MOE_TEACHER_LAYERS)
    print(f"  teacher-forced logits at full width and {cfg.n_layers} layers, kernel path "
          f"vs plain path")
    params = bundle_for(cfg).init(cfg, 0, device=dev)
    teacher_forced(torch, np, cfg, params)
    del params
    return run


# ---------------------------------------------------------------------------
# phase 4: teacher-forced logits, kernel path vs plain path
# ---------------------------------------------------------------------------

def run_path(torch, cfg, params, prompt, feed=None, frames=None):
    """Prefill + TEACHER_STEPS decode steps through the model's bundle (the
    encoder-decoder's prompt over ``frames``, cast to the weights' dtype);
    greedy unless ``feed`` gives the tokens.  Returns (f32 logits (steps+1,
    V), the tokens fed)."""
    from repro_torch.models import bundle_for
    bundle = bundle_for(cfg)
    dev = params.embed.table.device
    toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
    inputs = toks if frames is None else {"frames": frames.to(params.embed.table.dtype),
                                          "tokens": toks}
    logits, cache = bundle.prefill(cfg, params, inputs, max_seq=len(prompt) + TEACHER_STEPS)
    rows, fed = [logits[0, -1].float()], []
    for i in range(TEACHER_STEPS):
        nxt = int(rows[-1].argmax()) if feed is None else feed[i]
        fed.append(nxt)
        step = torch.tensor([[nxt]], dtype=torch.int32, device=dev)
        logits, cache = bundle.decode_step(cfg, params, cache, step)
        rows.append(logits[0, -1].float())
    return torch.stack(rows), fed


def teacher_forced(torch, np, cfg, params, frames=None):
    """Kernel path (bf16) against the plain path in bf16 and in f32: every
    ``ops`` entry patched to its plain version, the model's weights (and
    the encoder-decoder's ``frames``) cast to f32 for the last run."""
    from repro_torch.kernels import ops, ref

    plain_fns = {"attention": ref.attention_ref,
                 "decode_attention": ref.decode_attention_ref,
                 "moe_gating": ref.moe_gating_ref, "moe_router": ref.moe_router_ref,
                 "ssd_state_scan": ref.ssd_state_scan_ref}
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, TEACHER_PROMPT).tolist()
    reset_launches()
    kern, fed = run_path(torch, cfg, params, prompt, frames=frames)
    print(f"  kernel path launches: {launches_now()}")
    with contextlib.ExitStack() as stack:
        for name, fn in plain_fns.items():
            stack.enter_context(mock.patch.object(ops, name, fn))
        before = launches_now()
        plain, _ = run_path(torch, cfg, params, prompt, feed=fed, frames=frames)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = copy.deepcopy(params).float()
        plain32, _ = run_path(torch, cfg32, params32, prompt, feed=fed, frames=frames)
        del params32
        check(launches_now() == before, "a kernel launched on the plain path")
    check(bool(torch.isfinite(kern).all()), "non-finite logits on the kernel path")
    gap = (kern - plain).abs()
    kern_err = (kern - plain32).abs()
    plain_err = (plain - plain32).abs()
    print(f"  kernel vs plain (both bf16): max|dlogit|={float(gap.max()):.4e} "
          f"mean={float(gap.mean()):.4e}")
    print(f"  kernel bf16 vs plain f32: max|dlogit|={float(kern_err.max()):.4e} "
          f"mean={float(kern_err.mean()):.4e}")
    print(f"  plain bf16 vs plain f32: max|dlogit|={float(plain_err.max()):.4e} "
          f"mean={float(plain_err.mean()):.4e}  |logit| mean={float(plain32.abs().mean()):.4e}")
    # Bound: against the f32 plain path, the bf16 kernel path may err at
    # most TEACHER_SLACK times as much as the bf16 plain path does.  (Any
    # bf16 rounding grows through 28 random layers to about the same size,
    # so the kernel-vs-plain gap itself is as large as the bf16 error; a
    # wrong kernel moves the logits by their own size, ~0.7 on average.)
    check(float(kern_err.max()) <= TEACHER_SLACK * float(plain_err.max())
          and float(kern_err.mean()) <= TEACHER_SLACK * float(plain_err.mean()),
          f"kernel path errs more than {TEACHER_SLACK}x the bf16 plain path")


# ---------------------------------------------------------------------------
# phase 8: train qwen3-1.7b through run_training
# ---------------------------------------------------------------------------

def in_model_dtype(torch, cfg, batch):
    """``batch`` with its frames (the encoder-decoder's) in the config's
    dtype: ``SyntheticLM`` makes f32 frames, and the model, as the
    reference's, refuses frames of another dtype than its own."""
    if "frames" not in batch:
        return batch
    return {**batch, "frames": batch["frames"].to(getattr(torch, cfg.dtype))}


def loss_and_grads(torch, cfg, params, batch, remat="none"):
    from repro_torch.models import bundle_for
    loss = bundle_for(cfg).loss_fn(cfg, params, batch, remat=remat)
    return loss.item(), torch.autograd.grad(loss, list(params.parameters()))


def token_losses(torch, cfg, params, batch):
    """Each token's next-token loss (f32, (B * S,)), the MoE's aux term left
    out: the final norm, the output projection in the parameters' dtype and
    an f32 cross entropy, as ``chunked_lm_loss`` computes each chunk."""
    import torch.nn.functional as F
    from repro_torch.models import transformer as T
    from repro_torch.models.model import model_module
    with torch.no_grad():
        h = model_module(cfg).hidden(cfg, params, batch if cfg.family == "encdec"
                                     else batch["tokens"])
        logits = T.logits_of(cfg, params, h[0] if isinstance(h, tuple) else h).float()
        return F.cross_entropy(logits.flatten(0, 1), batch["labels"].flatten().long(),
                               reduction="none")


def gradient_gate(torch, np, dev, cfg, seq, plain, want, show, loss_by_token=False):
    """One batch (GATE_BATCH x ``seq``) through the kernel path, the plain
    path (the ``ops`` entries in ``plain`` patched to their plain versions,
    as phase 4 patches) and the plain path in f32 (remat "full" to fit):
    for every parameter, the kernel path's relative gradient error against
    f32 at most TEACHER_SLACK times the plain bf16 path's; the loss the
    same way: its error against f32, or with ``loss_by_token`` the relative
    error of the vector of the tokens' losses, as of a gradient.  The
    kernel path runs twice and must give the same loss and gradients bit
    for bit.  ``want`` gives each kernel's launches on the kernel path;
    ``show`` the parameters whose errors are printed.  Returns, per router
    call, the ids of the kernel path, of the plain bf16 path and of the
    plain router on the kernel path's own inputs."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops, ref
    from repro_torch.models import bundle_for
    params = bundle_for(cfg).init(cfg, 0, device=dev).requires_grad_(True)
    batch = in_model_dtype(torch, cfg, {
        k: torch.from_numpy(v).to(dev)
        for k, v in next(SyntheticLM(cfg, GATE_BATCH, seq, seed=7)).items()})
    routed = {"kernel": [], "plain": [], "plain_router": []}

    def recording(fn, path):
        def route(x, router, k):
            out = fn(x, router, k)
            routed[path].append(out[1].detach().clone())
            if path == "kernel":
                routed["plain_router"].append(
                    ref.moe_router_ref(x.detach(), router.detach(), k)[1])
            return out
        return route

    reset_launches()
    with mock.patch.object(ops, "moe_router", recording(ops.moe_router, "kernel")):
        loss_k, grads_k = loss_and_grads(torch, cfg, params, batch)
    launched = launches_now()
    check(all(launched[name] == want.get(name, 0) for name in launched),
          f"kernel path launches {launched}, expected {want}")
    loss_r, grads_r = loss_and_grads(torch, cfg, params, batch)
    same = loss_r == loss_k and all(torch.equal(a, b) for a, b in zip(grads_r, grads_k))
    del grads_r
    print(f"  the kernel path run twice on the gate batch: loss and {len(grads_k)} "
          f"gradients bit-equal {same}")
    check(same, "the kernel path's loss or gradients differ between two runs")
    launched = launches_now()
    with contextlib.ExitStack() as stack:
        for name, fn in plain.items():
            stack.enter_context(mock.patch.object(
                ops, name, recording(fn, "plain") if name == "moe_router" else fn))
        loss_p, grads_p = loss_and_grads(torch, cfg, params, batch)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = copy.deepcopy(params).float()
        batch32 = in_model_dtype(torch, cfg32, batch)
        loss_32, grads_32 = loss_and_grads(torch, cfg32, params32, batch32, remat="full")
        if loss_by_token:
            tok_p = token_losses(torch, cfg, params, batch)
            tok_32 = token_losses(torch, cfg32, params32, batch32)
        del params32
    routed["plain"] = routed["plain"][:len(routed["kernel"])]   # the bf16 pass's
    check(launches_now() == launched, "a kernel launched on the plain paths")
    worst, names = 0.0, [n for n, _ in params.named_parameters()]
    for name, gk, gp, g32 in zip(names, grads_k, grads_p, grads_32):
        norm = float(g32.norm())
        ek, ep = float((gk.float() - g32).norm()) / norm, float((gp.float() - g32).norm()) / norm
        worst = max(worst, ek / ep)
        check(ek <= TEACHER_SLACK * ep, f"{name}: kernel path's gradient err {ek:.4e} > "
                                        f"{TEACHER_SLACK} x the plain bf16 path's {ep:.4e}")
    lk, lp = abs(loss_k - loss_32), abs(loss_p - loss_32)
    print(f"  gradient gate (batch {GATE_BATCH} x {seq}): loss kernel {loss_k:.6f}, plain bf16 "
          f"{loss_p:.6f}, plain f32 {loss_32:.6f}; |dloss| vs f32 kernel {lk:.3e}, plain "
          f"{lp:.3e}; over {len(names)} parameter tensors the largest ratio of relative "
          f"gradient errors (kernel / plain bf16) {worst:.3f} (limit {TEACHER_SLACK})")
    for name in show:
        i = names.index(name)
        ek, ep = (float((g[i].float() - grads_32[i]).norm() / grads_32[i].norm())
                  for g in (grads_k, grads_p))
        print(f"    {name}: relative gradient err kernel {ek:.4e}, plain bf16 {ep:.4e}")
    if loss_by_token:
        tok_k = token_losses(torch, cfg, params, batch)
        norm = float(tok_32.norm())
        lk, lp = (float((t - tok_32).norm()) / norm for t in (tok_k, tok_p))
        print(f"  the tokens' losses: relative err vs f32 kernel {lk:.4e}, plain bf16 {lp:.4e} "
              f"(limit {TEACHER_SLACK}x; the mean's error above is a sum of signed errors)")
    check(lk <= TEACHER_SLACK * lp, f"kernel path's loss err {lk} > {TEACHER_SLACK} x the "
                                    f"plain bf16 path's {lp}")
    return routed


def train(torch, np, dev):
    """Phase 8.  Returns the run's kernel launches and the profiled steps'
    device us per step of each kernel."""
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.lake import MemoryLake
    from repro_torch.models import model_flops, param_count
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train.step import make_train_step, train_state_shape
    from repro_torch.train.trainer import run_training

    arch, B, S, steps, every, lr = TRAIN_RUN
    cfg = get_config(arch)
    n = param_count(cfg)
    print(f"  {n / 1e9:.3f} B params, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, {cfg.dtype}; AdamW moments f32")
    from repro_torch.kernels import ref
    gradient_gate(torch, np, dev, cfg, S, {"attention": ref.attention_ref},
                  {"flash_attention": cfg.n_layers, "flash_attention_bwd": cfg.n_layers},
                  ("blocks.0.attn.wq", "blocks.0.attn.wk", "blocks.0.attn.wv",
                   f"blocks.{cfg.n_layers - 1}.attn.wq", "embed.table"))
    torch.cuda.empty_cache()

    lake, times = MemoryLake(), []

    def on_step(step, loss):
        times.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = run_training(cfg, steps=steps, batch=B, seq=S, lake=lake, run_name="phase8",
                       ckpt_every=every, seed=0, lr=lr, device=dev, on_step=on_step)
    torch.cuda.synchronize()
    launches = launches_now()
    peak = torch.cuda.max_memory_allocated()
    print(f"  run_training: {res.steps_done} steps of {B} x {S} tokens in "
          f"{time.perf_counter() - t0:.1f} s (init, checkpoints at {every} and {steps} "
          f"included); launches {launches}")
    print(f"  losses: {[round(x, 4) for x in res.losses]}")
    check(res.steps_done == steps and all(np.isfinite(res.losses)), "non-finite loss")
    check(res.losses[-1] < res.losses[0], "the loss did not fall")
    for name in kernels():
        want = steps * cfg.n_layers if name.startswith("flash_attention") else 0
        check(launches[name] == want, f"{name}: {launches[name]} launches over {steps} "
                                      f"steps, expected {want}")
    step_s = statistics.median(b - a for a, b in zip(times[1:], times[2:]))   # steps 3-10
    flops = model_flops(cfg, ShapeConfig("phase8", "train", S, B))
    print(f"  ms_per_step={1e3 * step_s:.1f} (median of steps 3-{steps}) "
          f"tokens_per_s={B * S / step_s:.1f} model_flops_per_step={flops:.4e} "
          f"mfu={flops / step_s / PEAK_FLOPS['bfloat16']:.4f} (of 989 TFLOP/s) "
          f"peak_memory={peak / 2**30:.2f} GiB")

    # checkpoint: latest restored bit-equal; two more steps from it and from
    # the live state give the same losses
    optimizer = AdamW(lr=warmup_cosine(lr, max(steps // 20, 2), steps))
    template = train_state_shape(cfg, optimizer)
    live = res.state
    res.state = None
    restored, at = restore_checkpoint(lake, "phase8", template, device=dev)
    check(at == steps, f"latest checkpoint at {at}")
    same = [torch.equal(a, b) for a, b in zip(restored["params"].parameters(),
                                              live["params"].parameters())]
    for which in ("m", "v"):
        same += [torch.equal(getattr(restored["opt"], which)[k], getattr(live["opt"], which)[k])
                 for k in getattr(live["opt"], which)]
    same.append(torch.equal(restored["opt"].step, live["opt"].step))
    check(all(same), f"{same.count(False)} of {len(same)} restored tensors differ")
    del restored
    pipe = SyntheticLM(cfg, B, S, seed=99)
    extra = [{k: torch.from_numpy(v).to(dev) for k, v in next(pipe).items()} for _ in range(2)]
    step_fn = make_train_step(cfg, optimizer)

    def two_steps(state):
        losses = []
        for batch in extra:
            state, metrics = step_fn(state, batch)
            losses.append(metrics["loss"].item())
        return losses, state

    live_losses, live = two_steps(live)
    del live
    torch.cuda.empty_cache()
    state, _ = restore_checkpoint(lake, "phase8", template, device=dev)
    del lake
    restored_losses, state = two_steps(state)
    print(f"  checkpoint at step {at}: {len(same)} tensors restored bit-equal; two more "
          f"steps from the live state {live_losses}, from the restored one {restored_losses}")
    check(live_losses == restored_losses, "the restored state trains differently")

    batch = extra[0]
    state = check_remat_launches(torch, cfg, optimizer, state, batch,
                                 {"flash_attention": cfg.n_layers,
                                  "flash_attention_bwd": cfg.n_layers}, ("none", "full", "dots"))

    def one_step():
        nonlocal state
        state, metrics = step_fn(state, batch)
        metrics["loss"].item()

    served = profile_steps(torch, one_step, f"training step ({B} x {S} tokens)",
                           n=TRAIN_PROFILE_STEPS)
    del state
    torch.cuda.empty_cache()
    return {"launches": launches, "served": served}


# ---------------------------------------------------------------------------
# phase 9: the executors on the card, as a LIDC cluster calls them
# ---------------------------------------------------------------------------

def device_events(prof):
    """The device events of a finished ``torch.profiler`` run, as (name,
    start us, end us) from the trace's start: those of ``prof.events()``,
    read off the profiler's raw results without building that list, which
    takes tens of seconds for a whole job's events
    (``scripts/profile_sums.py`` holds the two to each other)."""
    from torch.autograd import DeviceType
    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    return [(e.name(), (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3)
            for e in results.events() if e.device_type() == DeviceType.CUDA]


def wrapper_us(events):
    """The device us of each wrapper's kernels (KERNEL_SYMBOLS) in
    ``device_events``."""
    by_name = {}
    for name, start, end in events:
        by_name[name] = by_name.get(name, 0.0) + end - start
    return {w: sum(us for name, us in by_name.items() if any(sym in name for sym in syms))
            for w, syms in KERNEL_SYMBOLS.items()}


def device_us(torch, fn):
    """``fn()`` under ``torch.profiler``, recording the host and the device;
    the device us of each wrapper's kernels over the whole call."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return wrapper_us(device_events(prof))


def kernel_us(torch, fn):
    """Phase 18's profile of a whole overlay job: ``fn()`` under
    ``torch.profiler`` recording the device only, giving its result, its
    wall seconds (the profiler on) and the device us of each wrapper's
    kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, wrapper_us(device_events(prof))


def executors(torch, np, dev):
    """Phase 9.  The port's train, serve and blast executors run as a LIDC
    cluster runs them (``ServiceEndpoint.executor(job, cluster)``), the real
    work on the card.  Train: the plan whole on one lake, then on a fresh
    lake its phase 0 on a cluster that dies and the whole plan again from
    another cluster, which must resume from the step-5 checkpoint and end
    on a bit-equal loss.  Serve: 8 requests of 32 tokens on 8 slots.  The
    cost model's virtual step times and memory estimate are printed beside
    the measured ones.  Returns each attention kernel's launches and device
    us per step."""
    import gc
    from types import SimpleNamespace

    import repro_torch.train.trainer as trainer
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.lake import MemoryLake
    from repro_torch.models import memory_estimate, param_count
    from repro_torch.runtime import executors as ex
    from repro_torch.runtime.fleet import standard_endpoints
    from repro_torch.runtime.protocol import Job, JobSpec
    from repro_torch.serve.engine import ServeEngine

    gc.collect()                  # phase 8's lake, ~41 GB of host memory
    arch, B, S, steps, every, _ = TRAIN_RUN
    requests, new_tokens, slots, max_seq = EXEC_SERVE
    cfg = get_config(arch)
    limit = 2 * param_count(cfg)  # above 1.72 B: the card computes the jobs
    endpoints = standard_endpoints([arch], ckpt_every=every, device=dev,
                                   real_param_limit=limit)
    check([(e.app, e.archs) for e in endpoints] == [("train", (arch,)), ("serve", (arch,)),
                                                    ("blast", ())],
          f"endpoints {[(e.app, e.archs) for e in endpoints]}")
    # the endpoints' executors, at phase 8's batch and sequence and at the
    # serving run's slots and max_seq (the endpoints keep the reference's
    # defaults, 4 x 32 and 4 x 64)
    train_exec = ex.make_train_executor(ckpt_every=every, batch=B, seq=S, device=dev,
                                        real_param_limit=limit)
    serve_exec = ex.make_serve_executor(max_batch=slots, max_seq=max_seq, device=dev,
                                        real_param_limit=limit)
    job = Job(JobSpec("train", {"arch": arch, "shape": "custom", "steps": steps}))
    run_name = f"train-{job.spec.signature()}"

    starts = []                   # host clock at the start of every train step
    make_train_step = trainer.make_train_step

    def timed_train_step(*args, **kwargs):
        fn = make_train_step(*args, **kwargs)

        def step(*a, **kw):
            starts.append(time.perf_counter())
            return fn(*a, **kw)
        return step

    def run(plan, phases, profiled=None):
        walls, us = [], None
        for i in phases:
            t0 = time.perf_counter()
            if i == profiled:
                us = device_us(torch, plan.phases[i][1])
            else:
                plan.phases[i][1]()
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return walls, us

    with mock.patch.object(trainer, "make_train_step", timed_train_step):
        # the plan whole, on one lake
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        lake = MemoryLake()
        plan = train_exec(job, SimpleNamespace(lake=lake))
        check(len(plan.phases) == steps // every, f"{len(plan.phases)} phases")
        walls, _ = run(plan, range(len(plan.phases)))
        whole = plan.finalize().payload
        launches_whole, trained = launches_now(), len(starts)
        peak_train = torch.cuda.max_memory_allocated()
        step_times = [1e3 * (b - a) for i in range(0, steps, every)   # within a phase
                      for a, b in zip(starts[i:i + every], starts[i + 1:i + every])]
        names = sorted(lake.objects)
        del plan, lake
        gc.collect()
        print(f"  train, the plan whole: phases {[round(w, 1) for w in walls]} s; payload "
              f"{whole}")
        print(f"  checkpoints: {names}")
        check(whole["real_compute"] and whole["run_name"] == run_name, "not a real run")
        check(trained == steps and names and all(
            n.startswith(f"/lidc/data/ckpt/{run_name}/") for n in names),
            f"{trained} steps; checkpoint names {names}")

        # a cluster dies after phase 0; another runs the same job on the lake
        reset_launches()
        starts.clear()
        lake = MemoryLake()
        dead = train_exec(job, SimpleNamespace(lake=lake))
        walls_dead, _ = run(dead, [0])
        del dead
        again = train_exec(job, SimpleNamespace(lake=lake))
        walls_again, train_us = run(again, range(len(again.phases)),
                                    profiled=len(again.phases) - 1)
        resumed = again.finalize().payload
        launches_resumed, trained_resumed = launches_now(), len(starts)
        del again, lake
        gc.collect()
    print(f"  train, killed after phase 0 ({walls_dead[0]:.1f} s) and run again from "
          f"another cluster: phases {[round(w, 1) for w in walls_again]} s (the last "
          f"profiled); payload {resumed}")
    check(resumed["real_compute"] and resumed["resumed_from"] == every,
          f"resumed from {resumed.get('resumed_from')}, expected {every}")
    check(resumed["final_loss"] == whole["final_loss"],
          f"final loss {resumed['final_loss']!r} resumed, {whole['final_loss']!r} whole")
    for launched, n in ((launches_whole, trained), (launches_resumed, trained_resumed)):
        check(n == steps, f"{n} steps trained, expected {steps}")
        for name in kernels():
            want = n * cfg.n_layers if name.startswith("flash_attention") else 0
            check(launched[name] == want, f"{name}: {launched[name]} launches over {n} "
                                          f"trained steps, expected {want}")
    train_us = {k: v / (steps - (steps // every - 1) * every)    # the last phase's steps
                for k, v in train_us.items()}

    # serve: the engine the executor builds is kept to read its counters
    engines = []

    class KeptEngine(ServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    sjob = Job(JobSpec("serve", {"arch": arch, "requests": requests,
                                 "new_tokens": new_tokens}))
    with mock.patch.object(ex, "ServeEngine", KeptEngine):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        served = serve_exec(sjob, None)
        torch.cuda.synchronize()
        serve_wall = time.perf_counter() - t0
        launches_serve = launches_now()
        peak_serve = torch.cuda.max_memory_allocated()
        eng = engines.pop()
        serve_us = device_us(torch, lambda: serve_exec(sjob, None))
        profiled_eng = engines.pop()
    print(f"  serve: {serve_wall:.2f} s (weights drawn on the card included); payload "
          f"{served.payload}; virtual duration {served.duration:.6f} s; launches "
          f"{launches_serve}")
    check(served.payload["real_compute"] and served.payload["tokens_out"] == requests
          * new_tokens, f"tokens_out {served.payload['tokens_out']}")
    check(launches_serve["flash_attention"] == requests * cfg.n_layers,
          f"flash_attention launches {launches_serve['flash_attention']} != {requests} "
          f"prefills x {cfg.n_layers} layers")
    check(launches_serve["flash_decode"] == eng.decode_steps * cfg.n_layers,
          f"flash_decode launches {launches_serve['flash_decode']} != {eng.decode_steps} "
          f"steps x {cfg.n_layers} layers")
    check(all(launches_serve[k] == 0 for k in ("flash_attention_bwd", "moe_gating",
                                                "moe_router", "moe_router_bwd",
                                                "ssd_state_scan")),
          "a kernel off the dense serving path launched")
    blast = endpoints[2].executor(Job(JobSpec("blast", {"srr": "SRR2931415", "db": "human"})),
                                  None)
    print(f"  blast (host, numpy): payload {blast.payload}")

    # the cost model beside the card
    decode_shape = ShapeConfig("serve", "decode", max_seq, slots)
    step_ms = statistics.median(step_times)
    print(f"  cost model vs card: training step {1e3 * whole['step_time_s']:.2f} ms virtual, "
          f"{step_ms:.2f} ms measured (median of {len(step_times)} host-clock steps; a "
          f"model-FLOPs share of {ex.ASSUMED_MFU * 1e3 * whole['step_time_s'] / step_ms:.4f} "
          f"against the assumed {ex.ASSUMED_MFU}); "
          f"decode step {1e3 * ex.roofline_step_time(cfg, decode_shape, 1):.3f} ms virtual, "
          f"{1e3 * eng.decode_s / eng.decode_steps:.2f} ms measured ({eng.decode_steps} "
          f"steps); serve job {served.duration:.4f} s virtual, {serve_wall:.2f} s wall")
    mem_train = ex.memory_model(job.spec, 1)
    print(f"  memory: train job memory_model {mem_train} (shape 'custom' is not in SHAPES); "
          f"memory_estimate at {B} x {S} "
          f"{memory_estimate(cfg, ShapeConfig('custom', 'train', S, B), 1) / 2**30:.2f} GiB, "
          f"measured peak {peak_train / 2**30:.2f} GiB; serve job memory_model "
          f"{ex.memory_model(sjob.spec, 1) / 2**30:.2f} GiB (no shape: the serve executor's "
          f"default {ex.SERVE_SHAPE.global_batch} slots of {ex.SERVE_SHAPE.seq_len} "
          f"positions), measured peak {peak_serve / 2**30:.2f} GiB")
    per_prefill = serve_us["flash_attention"] / requests
    per_decode = serve_us["flash_decode"] / profiled_eng.decode_steps
    out = {
        "flash_attention": {
            "launches_train": launches_whole["flash_attention"]
            + launches_resumed["flash_attention"],
            "launches_serve": launches_serve["flash_attention"],
            "us_per_training_step": round(train_us["flash_attention"], 2),
            "us_per_prefill": round(per_prefill, 2)},
        "flash_attention_bwd": {
            "launches_train": launches_whole["flash_attention_bwd"]
            + launches_resumed["flash_attention_bwd"],
            "us_per_training_step": round(train_us["flash_attention_bwd"], 2)},
        "flash_decode": {"launches_serve": launches_serve["flash_decode"],
                         "us_per_decode_step": round(per_decode, 2)},
    }
    print(f"  attention kernels in phase 9: {out}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 18: named jobs through the port's own overlay
# ---------------------------------------------------------------------------

def _job_done(label, handle):
    """A job must have completed with real compute; its error otherwise."""
    check(handle is not None, f"{label}: no cluster answered")
    check(handle.state == "Completed",
          f"{label}: {handle.state}, error {handle.error!r}, statuses "
          f"{handle.status_history[-1:] if handle.status_history else None}")
    check(handle.result is not None and handle.result.get("real_compute", True),
          f"{label}: result {handle.result}")


def _print_job(label, times, launches, us=None, per=None):
    """One job's virtual and wall seconds, the edge's counts, its launches
    and, for a job run under the profiler, the attention kernels' device us
    a step (``per``: kernel -> the steps its device time is divided by)."""
    edge = times.get("edge", {})
    shown = {k: v for k, v in launches.items() if v}
    per_step = {k: round(us[k] / n, 2) for k, n in per.items() if n} if us else {}
    print(f"  {label}: virtual {times['virtual_s']:.6f} s, wall {times['wall_s']:.2f} s"
          f"{' (device profiler on)' if us else ''}; at the edge {edge.get('interests')} Interests, "
          f"{edge.get('data')} Data, {edge.get('nacks')} Nacks, {edge.get('cs_hits')} "
          f"Content Store hits; launches {shown}; device us a step {per_step}")


def overlay_on_card(torch, np, dev):
    """Phase 18.  Named jobs expressed into overlays built from the port's
    own control plane, run by the port's executors on the card, fetched by
    name.  Returns the launches of the attention kernels in each job."""
    import gc

    import repro_torch.train.trainer as trainer
    from repro_torch.configs.base import get_config
    from repro_torch.core import LidcSystem, Name
    from repro_torch.examples import multicluster_failover, quickstart
    from repro_torch.models import param_count
    from repro_torch.runtime import executors as ex
    from repro_torch.runtime.fleet import standard_endpoints
    from repro_torch.serve.engine import ServeEngine

    check(not any(m == "repro" or m.startswith("repro.") for m in sys.modules),
          "the JAX package is loaded")
    trained = []
    make_train_step = trainer.make_train_step

    def counted_train_step(*args, **kwargs):
        fn = make_train_step(*args, **kwargs)

        def step(*a, **kw):
            trained.append(1)
            return fn(*a, **kw)
        return step

    out = {}
    demo = get_config(OVERLAY_ARCH)
    with mock.patch.object(trainer, "make_train_step", counted_train_step):
        # (a) the quickstart: the paper's whole story
        reset_launches()
        trained.clear()
        q, _, us = kernel_us(torch, lambda: quickstart.run(dev, arch=OVERLAY_ARCH,
                                                             verbose=False))
        launched, steps = launches_now(), len(trained)
        _job_done("quickstart", q["handle"])
        _job_done("quickstart repeat", q["again"])
        res = q["handle"].result
        fetched = q["system"].client.fetch(Name.parse(q["handle"].receipt["result_name"]))
        print(f"  quickstart: placed on {res['cluster']}, {len(q['handle'].status_history)} "
              f"status polls, final loss {res['final_loss']!r}, result "
              f"{q['handle'].receipt['result_name']}; the repeat: {q['new_jobs']} new jobs")
        check(fetched is not None and fetched.json()["job_id"] == res["job_id"],
              "the result is not fetched by its name")
        check(res["steps"] == 15 and steps == 15, f"{steps} steps trained, expected 15")
        check(q["new_jobs"] == 0 and q["again"].result == res,
              f"the repeat spawned {q['new_jobs']} jobs")
        for name in kernels():
            want = steps * demo.n_layers if name.startswith("flash_attention") else 0
            check(launched[name] == want, f"quickstart: {name} launched {launched[name]} "
                                          f"times over {steps} steps, expected {want}")
        _print_job("quickstart", q["first"], launched, us,
                   {"flash_attention": steps, "flash_attention_bwd": steps})
        _print_job("quickstart repeat", q["repeat"], {})
        out["quickstart"] = {k: launched[k] for k in ("flash_attention", "flash_attention_bwd")}
        del q
        gc.collect()

        # (b) the failover, and the same job unbroken through a fresh overlay
        reset_launches()
        trained.clear()
        f, _, us = kernel_us(torch, lambda: multicluster_failover.run(dev, arch=OVERLAY_ARCH,
                                                                       verbose=False))
        launched, steps = launches_now(), len(trained)
        _job_done("failover", f["handle"])
        _job_done("failover, unbroken", f["unbroken"])
        res, whole = f["handle"].result, f["unbroken"].result
        print(f"  failover: {f['killed']['cluster']} failed at virtual "
              f"{f['killed']['at']:.6f} s after checkpointing step {f['killed']['step']}; "
              f"completed on {res['cluster']} in {f['attempts']} attempts, resumed from "
              f"{res['resumed_from']}, final loss {res['final_loss']!r}; unbroken "
              f"{whole['final_loss']!r}; {steps} steps trained in both overlays")
        check(res["resumed_from"] == 10 and res["cluster"] != f["killed"]["cluster"],
              f"resumed from {res['resumed_from']} on {res['cluster']}")
        check(res["final_loss"] == whole["final_loss"],
              f"final loss {res['final_loss']!r} after the failover, {whole['final_loss']!r} "
              f"unbroken")
        for name in kernels():
            want = steps * demo.n_layers if name.startswith("flash_attention") else 0
            check(launched[name] == want, f"failover: {name} launched {launched[name]} "
                                          f"times over {steps} steps, expected {want}")
        _print_job("failover", f["failover"], launched, us,
                   {"flash_attention": steps, "flash_attention_bwd": steps})
        out["failover"] = {k: launched[k] for k in ("flash_attention", "flash_attention_bwd")}
        del f
        gc.collect()

    # (c) serving at full width and depth, and (d) blast, through one overlay
    arch, requests, new_tokens = OVERLAY_SERVE
    cfg = get_config(arch)
    engines = []

    class KeptEngine(ServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    system = LidcSystem()
    cluster = system.add_cluster(
        "h100", chips=1, memory_model=ex.memory_model,
        endpoints=standard_endpoints([arch], device=dev,
                                     real_param_limit=2 * param_count(cfg)))
    check(cluster.hbm_gb_per_chip == ex.HBM_GB_PER_CHIP, "not an 80 GB chip")
    fields = {"app": "serve", "arch": arch, "requests": requests, "new_tokens": new_tokens}
    edge0, v0 = quickstart.edge_counts(system), system.net.now
    with mock.patch.object(ex, "ServeEngine", KeptEngine):
        reset_launches()
        handle, wall, us = kernel_us(torch, lambda: system.client.run_job(fields))
        launched = launches_now()
    _job_done("serve", handle)
    eng = engines.pop()
    res = handle.result
    times = {"virtual_s": system.net.now - v0, "wall_s": wall,
             "edge": {k: v - edge0[k] for k, v in quickstart.edge_counts(system).items()}}
    print(f"  serve: {res}")
    check(res["tokens_out"] == requests * new_tokens,
          f"tokens_out {res['tokens_out']}, expected {requests * new_tokens}")
    check(launched["flash_attention"] == requests * cfg.n_layers,
          f"flash_attention launched {launched['flash_attention']} times, expected "
          f"{requests} prefills x {cfg.n_layers} layers")
    check(launched["flash_decode"] == eng.decode_steps * cfg.n_layers,
          f"flash_decode launched {launched['flash_decode']} times, expected "
          f"{eng.decode_steps} steps x {cfg.n_layers} layers")
    check(all(launched[k] == 0 for k in kernels()
              if k not in ("flash_attention", "flash_decode")),
          f"a kernel off the dense serving path launched: {launched}")
    _print_job("serve", times, launched, us,
               {"flash_attention": requests, "flash_decode": eng.decode_steps})
    out["serve"] = {k: launched[k] for k in ("flash_attention", "flash_decode")}
    del eng
    gc.collect()

    jobs0, edge1, v1 = len(cluster.jobs), quickstart.edge_counts(system), system.net.now
    reset_launches()
    t0 = time.perf_counter()
    again = system.client.run_job(fields)
    times = {"virtual_s": system.net.now - v1, "wall_s": time.perf_counter() - t0,
             "edge": {k: v - edge1[k] for k, v in quickstart.edge_counts(system).items()}}
    launched = launches_now()
    _job_done("serve repeat", again)
    check(len(cluster.jobs) == jobs0 and again.result == res and not any(launched.values())
          and times["edge"]["cs_hits"] > 0,
          f"the repeat was not answered from the cache: {len(cluster.jobs) - jobs0} new "
          f"jobs, launches {launched}, edge {times['edge']}")
    _print_job("serve repeat", times, launched)

    edge2, v2 = quickstart.edge_counts(system), system.net.now
    t0 = time.perf_counter()
    blast = system.client.run_job({"app": "blast", "srr": "SRR2931415", "db": "human"})
    times = {"virtual_s": system.net.now - v2, "wall_s": time.perf_counter() - t0,
             "edge": {k: v - edge2[k] for k, v in quickstart.edge_counts(system).items()}}
    _job_done("blast", blast)
    print(f"  blast: alignment score {blast.result['alignment_score']}, run time "
          f"{blast.result['run_time_s']} s (Table I, virtual)")
    _print_job("blast", times, {})
    check(not any(m == "repro" or m.startswith("repro.") for m in sys.modules),
          "the JAX package was loaded")
    del system, cluster, handle, again
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  attention launches in phase 18: {out}")
    return out


# ---------------------------------------------------------------------------
# phase 19: named sessions and named KV across a cluster failure
# ---------------------------------------------------------------------------

def failover_numbers(out) -> dict:
    """The numbers of a ``serving_failover.run()`` that ``FAILOVER_CPU``
    holds."""
    return {"survivor": out["survivor"], "kv_bytes_fetched": out["stats"]["kv_bytes_fetched"],
            "kv_fetches": out["stats"]["kv_fetches"], "resubmits": out["result"].resubmits,
            "tokens_done": out["ckpt"]["tokens_done"], "killed_at": out["killed"]["at"],
            "delivered_at_kill": out["killed"]["delivered"],
            "finished_at": out["result"].finished_at}


def kv_to_bytes(np, state) -> bytes:
    """A ``ServeEngine.kv_checkpoint`` as ``np.savez`` bytes, with no pickle
    (an ``eos`` of None is stored as -1)."""
    import io
    buf = io.BytesIO()
    np.savez(buf, k=state["k"], v=state["v"], prompt=np.asarray(state["prompt"], np.int64),
             out=np.asarray(state["out"], np.int64), max_new=np.int64(state["max_new"]),
             eos=np.int64(-1 if state["eos"] is None else state["eos"]),
             priority=np.int64(state["priority"]))
    return buf.getvalue()


def kv_from_bytes(np, blob) -> dict:
    """The checkpoint ``kv_to_bytes`` wrote, ready for ``ServeEngine.restore``."""
    import io
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        eos = int(z["eos"])
        return {"k": z["k"], "v": z["v"], "prompt": [int(t) for t in z["prompt"]],
                "out": [int(t) for t in z["out"]], "max_new": int(z["max_new"]),
                "eos": None if eos < 0 else eos, "priority": int(z["priority"])}


def carry_session_kv(np, make_engine, prompt, new_tokens, split, stage=None,
                     sid="phase19-session"):
    """Phase 19 (b) at any size.  Engine A serves ``prompt`` alone; after its
    ``split``-th token, its KV checkpoint is published as named Data under
    ``session_kv_name(sid)`` into the lake of a two-cluster port overlay, the
    first cluster fails, the survivor's node fetches the object by name
    through ``SegmentFetcher`` (as the serving plane fetches a session's KV
    on resume), and a fresh engine B restores it and decodes the rest; A then
    runs on, unbroken.  ``stage(label)`` is a context around each engine run
    ("a_first", "b", "a_rest").  Returns both streams and the transfer's
    numbers."""
    import hashlib

    from repro_torch.core import LidcSystem
    from repro_torch.datalake import SegmentFetcher
    from repro_torch.datalake.kv import session_kv_name

    stage = stage or (lambda label: contextlib.nullcontext())
    a = make_engine()
    req = a.submit(list(prompt), max_new=new_tokens)
    with stage("a_first"):
        a.run(max_steps=split - 1)      # the prefill's token, then one a step
    check(len(req.out) == split and not req.done,
          f"A holds {len(req.out)} tokens (done {req.done}), expected {split}")
    state = a.kv_checkpoint(req)
    blob = kv_to_bytes(np, state)
    published = hashlib.sha256(blob).hexdigest()

    system = LidcSystem()
    first, survivor = (system.add_cluster(f"pod{i}", chips=1) for i in range(2))
    system.net.run(until=0.25)          # the clusters' routes reach the edge
    name = session_kv_name(sid)
    system.lake.put_bytes(name, blob)
    system.overlay.fail_cluster(first.name)
    got = {}
    t0 = time.perf_counter()
    fetcher = SegmentFetcher(system.net, survivor.node, name, verify_key=system.lake.key,
                             on_complete=lambda b: got.setdefault("blob", b),
                             on_error=lambda r: got.setdefault("error", r)).start()
    system.net.run()
    wall = time.perf_counter() - t0
    check("blob" in got, f"the fetch of {name} failed: {got.get('error', fetcher.state)}")
    fetched = hashlib.sha256(got["blob"]).hexdigest()
    check(fetched == published, f"fetched sha256 {fetched}, published {published}")

    b = make_engine()
    restored = b.restore(kv_from_bytes(np, got["blob"]))
    with stage("b"):
        b.run()
    with stage("a_rest"):
        a.run()
    check(req.done and restored.done, f"A done {req.done}, B done {restored.done}")
    return {"a": list(req.out), "b": list(restored.out), "split": split,
            "kv_tokens": int(state["k"].shape[1]), "bytes": len(blob),
            "segments": int((fetcher.manifest or {}).get("segments", 0)),
            "published_sha256": published, "fetched_sha256": fetched,
            "virtual_s": fetcher.stats["duration"], "wall_s": wall,
            "fetch": {k: fetcher.stats[k] for k in ("segments", "retransmissions",
                                                    "timeouts", "max_cwnd")},
            "survivor": survivor.name, "a_steps": a.decode_steps, "b_steps": b.decode_steps}


def named_sessions_on_card(torch, np, dev):
    """Phase 19.  (a) the serving plane's failover example, (b) a real
    qwen3-1.7b session's KV carried across a cluster failure, (c) the
    batched-serving example on the card.  Returns the attention kernels'
    launches in each run."""
    import gc

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.examples import serve_batched, serving_failover
    from repro_torch.models import bundle_for
    from repro_torch.runtime import executors as ex
    from repro_torch.serve.engine import ServeEngine

    check(not any(m == "repro" or m.startswith("repro.") for m in sys.modules),
          "the JAX package is loaded")
    attention = ("flash_attention", "flash_decode")

    # (a) the modeled session, on the virtual clock
    t0 = time.perf_counter()
    f = serving_failover.run(verbose=False)
    wall = time.perf_counter() - t0
    got = failover_numbers(f)
    print(f"  (a) serving_failover: {f['killed']['name']} failed at virtual "
          f"{got['killed_at']!r} s with {got['delivered_at_kill']}/{serving_failover.MAX_NEW} "
          f"tokens delivered; resumed on {got['survivor']}, named KV fetched "
          f"{got['kv_bytes_fetched'] / 2**20:.4f} MiB in {got['kv_fetches']} fetch, "
          f"{got['resubmits']} resubmits, final checkpoint tokens_done={got['tokens_done']}, "
          f"session finished at virtual {got['finished_at']!r} s; wall {wall:.3f} s")
    check(f["result"].stream() == f["want"], "the resumed stream differs from token_at's")
    check(got == FAILOVER_CPU, f"the failover's numbers {got} differ from the CPU's "
                               f"{FAILOVER_CPU}")
    del f
    gc.collect()

    # (b) a real session's KV, on the card
    arch, plen, new, split, slots, max_seq = SESSION_KV_RUN
    cfg = get_config(arch)
    params = bundle_for(cfg).init(cfg, 0, device=dev)
    prompt = np.random.default_rng(19).integers(0, cfg.vocab, plen).tolist()
    stages = {}

    @contextlib.contextmanager
    def stage(label):
        reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            yield
            torch.cuda.synchronize()
        events = device_events(prof)
        stages[label] = {"launches": launches_now(), "us": wrapper_us(events),
                         "device_us": sum(end - start for _, start, end in events)}

    carried = carry_session_kv(
        np, lambda: ServeEngine(cfg, params, max_batch=slots, max_seq=max_seq, device=dev),
        prompt, new, split, stage=stage)
    a_steps, b_steps = carried["a_steps"], carried["b_steps"]
    print(f"  (b) {arch}: a {plen}-token prompt, {new} greedy tokens; KV after token "
          f"{split}: {carried['kv_tokens']} positions, {carried['bytes']} B in "
          f"{carried['segments']} segments, sha256 {carried['published_sha256'][:16]}...; "
          f"fetched on {carried['survivor']} after the first cluster failed in virtual "
          f"{carried['virtual_s']!r} s, wall {carried['wall_s']:.3f} s ({carried['fetch']})")
    check(carried["b"][:split] == carried["a"][:split], "B's restored tokens differ from A's")
    check(carried["b"][split:] == carried["a"][split:],
          f"B decoded {carried['b'][split:]}, A {carried['a'][split:]}")
    check(a_steps == new - 1 and b_steps == new - split,
          f"A ran {a_steps} decode steps, B {b_steps}")
    launched = {"session_a": {k: stages["a_first"]["launches"][k]
                              + stages["a_rest"]["launches"][k] for k in kernels()},
                "session_b": stages["b"]["launches"]}
    for run_name, steps, prefills in (("session_a", a_steps, 1), ("session_b", b_steps, 0)):
        n = launched[run_name]
        check(n["flash_attention"] == prefills * cfg.n_layers
              and n["flash_decode"] == steps * cfg.n_layers
              and all(n[k] == 0 for k in kernels() if k not in attention),
              f"{run_name}: launches {n}, expected {prefills} x {cfg.n_layers} prefill and "
              f"{steps} x {cfg.n_layers} decode")
    print(f"  (b) a_first: the {plen}-token prefill and {split - 1} decode steps, device us "
          f"{stages['a_first']['device_us']:.2f} (flash_attention "
          f"{stages['a_first']['us']['flash_attention']:.2f}, the prefill's {cfg.n_layers} "
          f"launches)")
    for label, steps in (("a_rest", new - split), ("b", b_steps)):
        s = stages[label]
        print(f"  (b) {label}: {steps} decode steps, device us a step "
              f"{s['device_us'] / steps:.2f} (flash_decode {s['us']['flash_decode'] / steps:.2f})")
    print(f"  (b) B's {new - split} tokens equal A's last {new - split}, bit for bit; "
          f"launches {launched}")
    del params, carried, stages
    gc.collect()
    torch.cuda.empty_cache()

    # (c) batched serving, the engine and serve jobs through an overlay
    engines = []

    class KeptEngine(ServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    with mock.patch.object(ex, "ServeEngine", KeptEngine), \
            mock.patch.object(serve_batched, "ServeEngine", KeptEngine):
        reset_launches()
        t0 = time.perf_counter()
        out = serve_batched.run(dev, arch=BATCHED_ARCH, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = launches_now()
    demo = get_config(BATCHED_ARCH)
    eng = out["engine"]
    print(f"  (c) serve_batched ({BATCHED_ARCH}): the engine served {eng['requests']} requests, "
          f"{eng['tokens_out']} tokens in {eng['decode_steps']} decode steps "
          f"({eng['tokens_out'] / eng['decode_steps']:.2f} tokens a step); {serve_batched.JOBS} "
          f"serve jobs on {out['clusters']}; virtual {out['virtual_s']!r} s, wall {wall:.2f} s")
    for h in out["handles"]:
        _job_done("serve_batched job", h)
    check(eng["requests"] == serve_batched.REQUESTS and len(out["handles"]) == serve_batched.JOBS
          and len(out["clusters"]) >= 2,
          f"{eng['requests']} requests, {len(out['handles'])} jobs on {out['clusters']}")
    prefills = serve_batched.REQUESTS + sum(h.result["requests"] for h in out["handles"])
    steps = sum(e.decode_steps for e in engines)
    check(len(engines) == 1 + serve_batched.JOBS and n["flash_attention"] == prefills * demo.n_layers
          and n["flash_decode"] == steps * demo.n_layers
          and all(n[k] == 0 for k in kernels() if k not in attention),
          f"serve_batched: {len(engines)} engines, launches {n}, expected {prefills} x "
          f"{demo.n_layers} prefill and {steps} x {demo.n_layers} decode")
    launched["serve_batched"] = n
    check(not any(m == "repro" or m.startswith("repro.") for m in sys.modules),
          "the JAX package was loaded")
    del engines, out
    gc.collect()
    torch.cuda.empty_cache()
    out = {run_name: {k: v[k] for k in attention} for run_name, v in launched.items()}
    print(f"  attention launches in phase 19: {out}")
    return out


# ---------------------------------------------------------------------------
# phase 10: train qwen3-moe-30b-a3b (4 layers) through run_training
# ---------------------------------------------------------------------------

def fingerprint(torch, t) -> int:
    """The sum, mod 2^64, over ``t``'s elements of each element's bits (as
    an integer) times (its position mod 65521) + 1: a change of any one
    element always changes it.  Computed on the device in chunks."""
    flat = t.detach().reshape(-1)
    bits = flat.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[flat.element_size()])
    total, chunk = 0, 1 << 25
    for i in range(0, bits.numel(), chunk):
        part = bits[i:i + chunk].long()
        weight = torch.arange(i, i + part.numel(), device=part.device) % 65521 + 1
        total += int((part * weight).sum())
    return total % (1 << 64)


def state_fingerprints(torch, state):
    """name -> fingerprint of every tensor of a train state: the
    parameters, both AdamW moments and the step."""
    fps = {f"params.{n}": fingerprint(torch, p) for n, p in state["params"].named_parameters()}
    for which in ("m", "v"):
        fps.update({f"opt.{which}.{n}": fingerprint(torch, t)
                    for n, t in getattr(state["opt"], which).items()})
    fps["opt.step"] = fingerprint(torch, state["opt"].step)
    return fps


def product_us(torch, step, shapes, n):
    """Device us per call of ``step`` of the ``aten::mm`` calls whose two
    input shapes are among ``shapes`` (torch.profiler, shapes recorded);
    None where the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
    except RuntimeError as exc:       # a diagnostic: the profiler may be unavailable
        print(f"  torch.profiler failed ({exc}); product time not measured")
        return None
    us = 0.0
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key == "aten::mm" and [list(x) for x in e.input_shapes[:2]] in shapes:
            us += getattr(e, "device_time_total", 0)
    return us / n if us else None


# the kernels that remat "full" and "dots" run again in the backward pass
FORWARD_KERNELS = ("flash_attention", "moe_router", "ssd_state_scan")


def launches_per_step(per_step, remat):
    """A training step's launches of each kernel under ``remat``, from its
    launches under "none"."""
    again = 1 if remat == "none" else 2
    return {name: n * (again if name in FORWARD_KERNELS else 1)
            for name, n in per_step.items()}


def train_and_replay(torch, np, dev, cfg, run_name, run, per_step):
    """Phases 10 and 11: ``run_training`` of ``run`` = (batch, sequence,
    steps, checkpoint at, peak lr, remat) with only the checkpoint at
    ``every`` written (tens of GB of host arrays each) and the live state it
    is taken from fingerprinted.  Gates: each kernel's launches over the run
    (``per_step`` gives a step's under remat "none"), finite losses that
    fall, the checkpoint restored bit-equal to that live state, and the
    steps after it, on the run's own batches, giving the run's losses and
    final state bit for bit.  Returns the run's launches, seconds per step
    and peak bytes, and the replayed state, its optimizer and the first
    replayed batch on the card."""
    import gc

    import repro_torch.train.trainer as trainer
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.data import SyntheticLM
    from repro_torch.lake import MemoryLake
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train.step import train_state_shape

    B, S, steps, every, lr, remat = run
    lake, times, at_save = MemoryLake(), [], {}
    save_checkpoint, make_step = trainer.save_checkpoint, trainer.make_train_step

    def save_first(lake_, name, step, state, meta=None):
        if step != every:
            return None
        at_save.update(state_fingerprints(torch, state))
        return save_checkpoint(lake_, name, step, state, meta)

    def make_step_in_model_dtype(cfg_, *args, **kw):
        step_fn = make_step(cfg_, *args, **kw)
        return lambda state, batch: step_fn(state, in_model_dtype(torch, cfg_, batch))

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(trainer, "save_checkpoint", save_first), \
            mock.patch.object(trainer, "make_train_step", make_step_in_model_dtype):
        res = trainer.run_training(cfg, steps=steps, batch=B, seq=S, lake=lake,
                                   run_name=run_name, ckpt_every=every, seed=0, lr=lr,
                                   remat=remat, device=dev, on_step=lambda s, l: times.append(
                                       time.perf_counter()))
    torch.cuda.synchronize()
    launches = launches_now()
    peak = torch.cuda.max_memory_allocated()
    print(f"  run_training: {res.steps_done} steps of {B} x {S} tokens, remat {remat!r}, in "
          f"{time.perf_counter() - t0:.1f} s (init and the step-{every} checkpoint included); "
          f"launches {launches}")
    print(f"  losses: {[round(x, 4) for x in res.losses]}")
    check(res.steps_done == steps and all(np.isfinite(res.losses)), "non-finite loss")
    check(res.losses[-1] < res.losses[0], "the loss did not fall")
    want = launches_per_step(per_step, remat)
    for name in kernels():
        check(launches[name] == steps * want.get(name, 0),
              f"{name}: {launches[name]} launches over {steps} steps, expected "
              f"{steps * want.get(name, 0)}")
    step_s = statistics.median(b - a for a, b in zip(times[1:], times[2:]))   # step 3 on
    final = state_fingerprints(torch, res.state)
    res.state = None
    gc.collect()
    torch.cuda.empty_cache()

    optimizer = AdamW(lr=warmup_cosine(lr, max(steps // 20, 2), steps))   # run_training's
    state, at = restore_checkpoint(lake, run_name, train_state_shape(cfg, optimizer),
                                   device=dev)
    del lake
    gc.collect()
    restored = state_fingerprints(torch, state)
    moved = [k for k in at_save if restored.get(k) != at_save[k]]
    print(f"  checkpoint at step {at}: {len(restored)} tensors restored, {len(moved)} differ "
          f"from the live state's fingerprints at step {every}")
    check(at == every and set(restored) == set(at_save) and not moved,
          f"restored step {at}; tensors that differ: {moved[:5]}")
    stream = SyntheticLM(cfg, B, S, seed=0)
    batches = [next(stream) for _ in range(steps)][every:]
    step_fn = make_step_in_model_dtype(cfg, optimizer, remat=remat)
    replayed = []
    for b in batches:
        state, metrics = step_fn(state, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        replayed.append(float(metrics["loss"]))
    moved = [k for k, fp in state_fingerprints(torch, state).items() if final.get(k) != fp]
    print(f"  steps {every + 1}-{steps} from the restored state: losses {replayed}, the run's "
          f"{res.losses[every:]}; {len(moved)} of {len(final)} final tensors differ")
    check(replayed == res.losses[every:], "the restored state trains differently")
    check(not moved, f"the replayed final state differs: {moved[:5]}")
    batch = in_model_dtype(torch, cfg, {k: torch.from_numpy(v).to(dev)
                                        for k, v in batches[0].items()})
    return {"launches": launches, "step_s": step_s, "peak": peak, "state": state,
            "optimizer": optimizer, "batch": batch}


def check_remat_launches(torch, cfg, optimizer, state, batch, per_step, policies):
    """One step under each remat policy in ``policies``; its launches
    against ``launches_per_step``.  Returns the state."""
    from repro_torch.train.step import make_train_step
    for remat in policies:
        reset_launches()
        state, _ = make_train_step(cfg, optimizer, remat=remat)(state, batch)
        torch.cuda.synchronize()
        got, want = launches_now(), launches_per_step(per_step, remat)
        print(f"  remat {remat!r}: launches per step {got}")
        check(all(got[name] == want.get(name, 0) for name in got),
              f"remat {remat}: {got}, expected {want}")
    return state


def train_moe(torch, np, dev):
    """Phase 10.  Returns the run's kernel launches, the profiled steps'
    device us per step of each kernel and of the router backward's two
    products."""
    import gc

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.kernels import ref
    from repro_torch.models import model_flops, param_count
    from repro_torch.train.step import make_train_step

    gc.collect()                  # phases 8 and 9's lakes, tens of GB of host memory
    arch, layers, B, S, steps, every, lr = MOE_TRAIN_RUN
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    n, active = param_count(cfg), param_count(cfg, active_only=True)
    experts = 3 * cfg.n_experts * cfg.d_model * cfg.d_ff * layers
    print(f"  {n / 1e9:.3f} B params at {layers} of {full.n_layers} layers ({experts / 1e9:.3f} "
          f"B of them expert weights, {active / 1e9:.3f} B active), d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.top_k}, {cfg.dtype}; AdamW moments f32: "
          f"{(4 * n + 8 * n) / 1e9:.1f} GB of weights, gradients and moments")
    per_step = {"flash_attention": layers, "flash_attention_bwd": layers,
                "moe_router": layers, "moe_router_bwd": layers}
    routed = gradient_gate(
        torch, np, dev, cfg, S, {"attention": ref.attention_ref,
                                 "moe_router": ref.moe_router_ref}, per_step,
        ("blocks.0.moe.router", "blocks.0.moe.w_gate", "blocks.0.moe.w_down",
         f"blocks.{layers - 1}.moe.router", "blocks.0.attn.wq", "embed.table"),
        loss_by_token=True)
    check(all(len(ids) == layers for ids in routed.values()), "router calls not recorded")
    total = sum(a.numel() for a in routed["kernel"])
    differ = {path: sum(int((a != b).sum()) for a, b in zip(routed["kernel"], routed[path]))
              for path in ("plain", "plain_router")}
    print(f"  routing on the gate batch, (token, rank) ids of {total} that differ from the "
          f"kernel path's: the plain bf16 path {differ['plain']} (its attention rounds "
          f"otherwise, so the router sees other inputs); the plain router on the kernel "
          f"path's own inputs {differ['plain_router']}")
    del routed
    torch.cuda.empty_cache()

    # the run: only step `every`'s checkpoint is written (each is ~37 GB of
    # host arrays)
    run = train_and_replay(torch, np, dev, cfg, "phase10", (B, S, steps, every, lr, "none"),
                           per_step)
    step_s, batch = run["step_s"], run["batch"]
    flops = model_flops(cfg, ShapeConfig("phase10", "train", S, B))
    print(f"  ms_per_step={1e3 * step_s:.1f} (median of steps 3-{steps}) "
          f"tokens_per_s={B * S / step_s:.1f} model_flops_per_step={flops:.4e} "
          f"mfu={flops / step_s / PEAK_FLOPS['bfloat16']:.4f} (of 989 TFLOP/s, active "
          f"parameters) peak_memory={run['peak'] / 2**30:.2f} GiB")
    optimizer = run["optimizer"]
    state = check_remat_launches(torch, cfg, optimizer, run.pop("state"), batch, per_step,
                                 ("none", "full", "dots"))
    step_fn = make_train_step(cfg, optimizer)

    def one_step():
        nonlocal state
        state, metrics = step_fn(state, batch)
        metrics["loss"].item()

    served = profile_steps(torch, one_step, f"training step ({B} x {S} tokens)",
                           n=TRAIN_PROFILE_STEPS)
    T = B * S
    products = product_us(torch, one_step, [[[T, cfg.n_experts], [cfg.n_experts, cfg.d_model]],
                                            [[cfg.d_model, T], [T, cfg.n_experts]]],
                          TRAIN_PROFILE_STEPS)
    print(f"  the router backward's two f32 products (dlogits @ router^T, x^T @ dlogits): "
          f"device us per step {'not measured' if products is None else f'{products:.2f}'}; "
          f"moe_router_bwd {served['moe_router_bwd']:.2f}, moe_router {served['moe_router']:.2f}")
    del state
    torch.cuda.empty_cache()
    return {"launches": run["launches"], "served": served, "products_us": products}


# ---------------------------------------------------------------------------
# phase 11: train zamba2-2.7b (full depth) through run_training
# ---------------------------------------------------------------------------

def hybrid_step_bounds(cfg, B, S, per_step):
    """Least device ms per training step of each of the hybrid's kernels at
    (B, S) (``bound_of`` of one launch's bytes and operations, times its
    launches a step): the scan (chunk states and decays read, prefix and
    final written), its reverse (g_prefix and prefix read, d_states
    written, the decays and their gradient), the shared block's attention
    (q, k, v read, o and the log-sum-exp written) and its backward (q, k,
    v, o, dO, lse read, dq, dk, dv written)."""
    C = -(-S // cfg.chunk)
    H, P, N = cfg.ssm_heads, cfg.ssm_expand * cfg.d_model // cfg.ssm_heads, cfg.ssm_state
    scan, decays, final = B * C * H * P * N, B * C * H, B * H * P * N
    q, kv, pairs = B * S * cfg.n_heads * cfg.hd, B * S * cfg.n_kv_heads * cfg.hd, S * (S + 1) // 2
    lse = B * cfg.n_heads * S
    one = {
        "ssd_state_scan": bound_of(2.0 * scan, 4.0 * (2 * scan + decays + final), "float32"),
        "ssd_state_scan_bwd": bound_of(4.0 * scan, 4.0 * (3 * scan + 2 * decays), "float32"),
        "flash_attention": bound_of(4.0 * B * cfg.n_heads * cfg.hd * pairs,
                                    2.0 * (2 * q + 2 * kv) + 4.0 * lse, "bfloat16"),
        "flash_attention_bwd": bound_of(10.0 * B * cfg.n_heads * cfg.hd * pairs,
                                        2.0 * (4 * q + 4 * kv) + 4.0 * lse, "bfloat16"),
    }
    return {name: (ms * per_step[name], by) for name, (ms, by) in one.items()}


def train_hybrid(torch, np, dev):
    """Phase 11.  Returns the run's kernel launches and the profiled steps'
    device us per step of each kernel."""
    import gc

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.kernels import ref
    from repro_torch.models import model_flops, param_count
    from repro_torch.train.step import make_train_step

    gc.collect()                  # phase 10's lake, tens of GB of host memory
    arch, B, S, steps, every, lr, remat = HYBRID_TRAIN_RUN
    cfg = get_config(arch)
    n, supers = param_count(cfg), cfg.n_layers // cfg.attn_every
    print(f"  {n / 1e9:.3f} B params, {cfg.n_layers} Mamba2 blocks, the shared block applied "
          f"{supers} times (head dim {cfg.hd}), d_model {cfg.d_model}, {cfg.dtype}; AdamW "
          f"moments f32: {12 * n / 1e9:.1f} GB of weights, gradients and moments")
    per_step = {"flash_attention": supers, "flash_attention_bwd": supers,
                "ssd_state_scan": cfg.n_layers, "ssd_state_scan_bwd": cfg.n_layers}
    gradient_gate(
        torch, np, dev, cfg, S, {"attention": ref.attention_ref,
                                 "ssd_state_scan": ref.ssd_state_scan_ref}, per_step,
        ("mamba.0.0.ssm.a_log", "mamba.0.0.ssm.in_proj", "mamba.0.0.ssm.dt_bias",
         f"mamba.{supers - 1}.{cfg.attn_every - 1}.ssm.out_proj", "shared.attn.wq",
         "proj_in.0.w", "embed.table"),
        loss_by_token=True)
    torch.cuda.empty_cache()

    # the run: only step `every`'s checkpoint is written (~31 GB of host
    # arrays)
    run = train_and_replay(torch, np, dev, cfg, "phase11", (B, S, steps, every, lr, remat),
                           per_step)
    step_s, batch, optimizer = run["step_s"], run["batch"], run["optimizer"]
    flops = model_flops(cfg, ShapeConfig("phase11", "train", S, B))
    print(f"  ms_per_step={1e3 * step_s:.1f} (median of steps 3-{steps}) "
          f"tokens_per_s={B * S / step_s:.1f} model_flops_per_step={flops:.4e} "
          f"mfu={flops / step_s / PEAK_FLOPS['bfloat16']:.4f} (of 989 TFLOP/s) "
          f"peak_memory={run['peak'] / 2**30:.2f} GiB")
    # remat "none" at this batch does not fit; the gate batch counted it
    state = check_remat_launches(torch, cfg, optimizer, run.pop("state"), batch, per_step,
                                 ("full", "dots"))
    step_fn = make_train_step(cfg, optimizer, remat=remat)

    def one_step():
        nonlocal state
        state, metrics = step_fn(state, batch)
        metrics["loss"].item()

    served = profile_steps(torch, one_step, f"training step ({B} x {S} tokens, remat "
                                            f"{remat!r})", n=TRAIN_PROFILE_STEPS)
    bounds = hybrid_step_bounds(cfg, B, S, launches_per_step(per_step, remat))
    print("  device us per training step, beside the least the card could take: " + "; ".join(
        f"{name} {served[name]:.1f} (bound {1e3 * ms:.1f} by {by})"
        for name, (ms, by) in bounds.items()))
    del state
    torch.cuda.empty_cache()
    return {"launches": run["launches"], "served": served}


# ---------------------------------------------------------------------------
# phase 12: xlstm-350m, served and trained at full width and depth
# ---------------------------------------------------------------------------

def step_measures(torch, cfg, shape, step_s, peak, f32=False):
    """ms and tokens a step, the model-FLOPs share of 989 TFLOP/s (with
    ``f32`` also of the f32 peak, 67 TFLOP/s), peak memory: one line."""
    from repro_torch.models import model_flops
    flops = model_flops(cfg, shape)
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    f32_share = (f" mfu_f32={flops / step_s / PEAK_FLOPS['float32']:.4f} (of the f32 peak, "
                 f"67 TFLOP/s)" if f32 else "")
    return (f"ms_per_step={1e3 * step_s:.1f} tokens_per_s={tokens / step_s:.1f} "
            f"model_flops_per_step={flops:.4e} mfu={flops / step_s / PEAK_FLOPS['bfloat16']:.4f} "
            f"(of 989 TFLOP/s){f32_share} peak_memory={peak / 2**30:.2f} GiB")


def repeat_gate(torch, cfg, params, batch):
    """The loss and every gradient of one batch, twice: bit-equal."""
    loss_a, grads_a = loss_and_grads(torch, cfg, params, batch)
    loss_b, grads_b = loss_and_grads(torch, cfg, params, batch)
    same = loss_a == loss_b and all(torch.equal(a, b) for a, b in zip(grads_a, grads_b))
    print(f"  one batch's loss and {len(grads_a)} gradients computed twice: bit-equal {same}")
    check(same, "a repeated step's loss or gradients differ")


def xlstm_f32_gates(torch, np, dev, cfg):
    """At one group (slstm_every blocks) of full width in f32: prefill then
    decode steps against a longer prefill; the mLSTM's parallel, chunkwise
    and recurrent forms against each other; and the logits, the loss and
    every gradient on the card against the port's CPU path in f64 on the
    same weights and tokens (TF32 off), a reference no host's f32 rounding
    moves.  The CPU's own f32 run is held to the same f64 reference and
    printed beside the gate (not gated), which shows how far f32 rounding
    alone moves each tensor."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import bundle_for
    from repro_torch.models import xlstm as X
    P, extra, gate_tokens = XLSTM_F32
    cfg = dataclasses.replace(cfg, n_layers=cfg.slstm_every, dtype="float32")
    params = bundle_for(cfg).init(cfg, 1, device=dev)
    toks = torch.tensor(np.random.default_rng(5).integers(0, cfg.vocab, (1, P + extra)),
                        dtype=torch.int32, device=dev)
    full, _ = X.prefill(cfg, params, toks)
    _, cache = X.prefill(cfg, params, toks[:, :P])
    for i in range(P, P + extra):
        logits, cache = X.decode_step(cfg, params, cache, toks[:, i:i + 1])
    gap = float((logits - full).abs().max() / full.abs().max())
    print(f"  f32, {cfg.n_layers} blocks: prefill({P}) + {extra} decode steps vs "
          f"prefill({P + extra}): max |dlogit| / max |logit| = {gap:.3e} (limit 1e-3)")
    check(gap <= 1e-3, f"decode after prefill drifts from the longer prefill: {gap}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    blk = params.mlstm[0][0].mlstm
    d_inner, H, hd = X.dims(cfg)
    with torch.no_grad():
        x = torch.randn((1, P, cfg.d_model), generator=gen, device=dev) * 0.3
        par, chunk = X.mlstm_parallel(cfg, blk, x), X.mlstm_chunkwise(cfg, blk, x)
        cell = {"C": torch.zeros((1, H, hd, hd), device=dev),
                "n": torch.zeros((1, H, hd), device=dev),
                "m": torch.full((1, H), -1e30, device=dev),
                "conv": torch.zeros((1, cfg.conv_kernel - 1, d_inner), device=dev)}
        outs = []
        for t in range(P):
            o, cell = X.mlstm_step(cfg, blk, x[:, t:t + 1], cell)
            outs.append(o)
        rec = torch.cat(outs, dim=1)
    for name, got in (("chunkwise", chunk), ("recurrent", rec)):
        err = float((got - par).abs().max())
        ok = bool(((got - par).abs() <= 3e-4 + 3e-3 * par.abs()).all())
        print(f"  mLSTM {name} vs parallel, one block, {P} tokens: max_abs_err={err:.3e} "
              f"(atol 3e-4, rtol 3e-3)")
        check(ok, f"the mLSTM's {name} form disagrees with the parallel form: {err}")

    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in next(SyntheticLM(cfg, 1, gate_tokens, seed=7)).items()}
    cpu_params = copy.deepcopy(params).cpu()
    f64_params = copy.deepcopy(cpu_params).double()
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    rows = []
    for p, b in ((params, batch), (cpu_params, cpu_batch), (f64_params, cpu_batch)):
        p.requires_grad_(True)
        t0 = time.perf_counter()
        logits = X.apply(cfg, p, b["tokens"])
        loss, grads = loss_and_grads(torch, cfg, p, b)
        rows.append((logits.cpu(), loss, [g.cpu() for g in grads], time.perf_counter() - t0))

    def errs(got, want):
        (lg, sg, gg, _), (lw, sw, gw, _) = got, want
        out = {"logits": float((lg.double() - lw).abs().max() / lw.abs().max()),
               "loss": abs(sg - sw) / abs(sw)}
        for (name, _), a, b in zip(params.named_parameters(), gg, gw):
            out[name] = float((a.double() - b).abs().max() / b.abs().max())
        return out

    worst, cpu = errs(rows[0], rows[2]), errs(rows[1], rows[2])
    top = max(worst, key=worst.get)
    print(f"  card f32 vs CPU f64, 1 x {gate_tokens} tokens ({rows[0][3]:.1f} s card, "
          f"{rows[1][3]:.1f} s CPU f32, {rows[2][3]:.1f} s CPU f64): logits "
          f"{worst['logits']:.3e}, loss {worst['loss']:.3e}, over {len(rows[0][2])} gradients "
          f"the largest {worst[top]:.3e} ({top}); each max |d| / max |f64| (limit 1e-4)")
    for name in sorted(worst, key=worst.get, reverse=True)[:6]:
        print(f"    {name}: card f32 vs f64 {worst[name]:.3e}; CPU f32 vs f64 {cpu[name]:.3e}")
    top_cpu = max(cpu, key=cpu.get)
    print(f"  CPU f32 vs f64 (not gated): logits {cpu['logits']:.3e}, the largest "
          f"{cpu[top_cpu]:.3e} ({top_cpu})")
    check(all(v <= 1e-4 for v in worst.values()),
          f"the card's f32 run and the f64 reference differ: {top} {worst[top]}")
    del params, cpu_params, f64_params, cache
    torch.cuda.empty_cache()


def serve_and_train_xlstm(torch, np, dev):
    """Phase 12.  Returns the serving and training runs' launches (none of
    the repo's kernels: the path has none) and device us."""
    import gc

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.models import bundle_for, param_count
    from repro_torch.models import xlstm as X
    from repro_torch.train.step import make_prefill, make_train_step

    gc.collect()                  # phase 11's lake
    arch, B, S, steps, short = XLSTM_SERVE
    cfg = get_config(arch)
    n, (d_inner, H, hd) = param_count(cfg), X.dims(cfg)
    t0 = time.perf_counter()
    params = bundle_for(cfg).init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    print(f"  on {card_line()}")
    print(f"  {n / 1e9:.3f} B params, {cfg.n_layers} blocks ({X.n_groups(cfg)} groups of "
          f"{cfg.slstm_every - 1} mLSTM + 1 sLSTM), d_model {cfg.d_model}, mLSTM {H} heads of "
          f"{hd}, sLSTM heads of {cfg.d_model // cfg.n_heads}, {cfg.dtype}; init "
          f"{time.perf_counter() - t0:.1f} s; no repo kernel on this path")
    run = serve_steps(torch, np, dev, cfg, params, B, S, S + steps, steps, {}, {})
    print("  prefill " + step_measures(torch, cfg, ShapeConfig("p", "prefill", S, B),
                                        run["prefill_s"], torch.cuda.max_memory_allocated()))
    print("  decode " + step_measures(torch, cfg, ShapeConfig("d", "decode", S + steps, B),
                                       run["ms_per_step"] / 1e3,
                                       torch.cuda.max_memory_allocated()))
    toks = torch.tensor(np.random.default_rng(4).integers(0, cfg.vocab, (1, short)),
                        dtype=torch.int32, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    logits, cache = make_prefill(cfg)(params, {"tokens": toks})
    torch.cuda.synchronize()
    print(f"  one prompt of {short} tokens (not a multiple of the chunk {cfg.chunk}: stepped "
          f"token by token): {1e3 * (time.perf_counter() - t0):.1f} ms, launches "
          f"{launches_now()}")
    check(int(cache["index"]) == short and bool(torch.isfinite(logits).all())
          and not any(launches_now().values()), "the short prompt's prefill")
    del params, cache, logits
    torch.cuda.empty_cache()

    xlstm_f32_gates(torch, np, dev, cfg)

    B, S = XLSTM_TRAIN_RUN[:2]
    trained = train_and_replay(torch, np, dev, cfg, "phase12", XLSTM_TRAIN_RUN, {})
    print("  " + step_measures(torch, cfg, ShapeConfig("t", "train", S, B), trained["step_s"],
                               trained["peak"]))
    state, batch = trained.pop("state"), trained["batch"]
    repeat_gate(torch, cfg, state["params"], batch)
    step_fn = make_train_step(cfg, trained["optimizer"], remat=XLSTM_TRAIN_RUN[-1])

    def one_step():
        nonlocal state
        state, metrics = step_fn(state, batch)
        metrics["loss"].item()

    served = profile_steps(torch, one_step, f"training step ({B} x {S} tokens)", n=1,
                           host_ops=False)
    del state
    torch.cuda.empty_cache()
    return {"serve": run, "train": {"launches": trained["launches"], "served": served}}


# ---------------------------------------------------------------------------
# phase 13: seamless-m4t-large-v2, served and trained at full width and depth
# ---------------------------------------------------------------------------

class _ByDtype:
    """A kernel wrapper that also counts its calls by q's dtype into
    ``counts``; its ``launches`` is the wrapped function's own count, which
    the wrapped function increments through its module-level name."""

    def __init__(self, fn, counts):
        self.fn, self.counts = fn, counts

    def __call__(self, q, *args, **kw):
        key = str(q.dtype).removeprefix("torch.")
        self.counts[key] = self.counts.get(key, 0) + 1
        return self.fn(q, *args, **kw)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n


@contextlib.contextmanager
def attention_launches_by_dtype(torch):
    """Counts each attention kernel's launches by dtype inside the block:
    {"flash_attention": {dtype: n}, "flash_attention_bwd": {...}}."""
    from repro_torch.kernels import flash_attention as fa
    counts = {"flash_attention": {}, "flash_attention_bwd": {}}
    with mock.patch.object(fa, "flash_attention_fwd",
                           _ByDtype(fa.flash_attention_fwd, counts["flash_attention"])), \
            mock.patch.object(fa, "flash_attention_bwd",
                              _ByDtype(fa.flash_attention_bwd, counts["flash_attention_bwd"])):
        yield counts


def attention_dtype_gate(torch, fn, dtype_name, n):
    """``fn()`` launches each attention kernel ``n`` times, all in
    ``dtype_name``, forward and backward; returns ``fn``'s result."""
    with attention_launches_by_dtype(torch) as by_dtype:
        out = fn()
    print(f"  attention launches by dtype: {by_dtype}")
    want = {dtype_name: n}
    check(by_dtype == {"flash_attention": want, "flash_attention_bwd": want},
          f"expected every attention in {dtype_name}, forward and backward: {by_dtype}")
    return out


def serve_and_train_seamless(torch, np, dev):
    """Phase 13.  Returns the serving (prefill and decode) and training
    runs' launches and device us of each kernel."""
    import gc

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.kernels import ref
    from repro_torch.models import bundle_for, param_count
    from repro_torch.train.step import make_prefill, make_train_step

    gc.collect()                  # phase 12's lake
    arch, B, F_, max_seq, steps = SEAMLESS_SERVE
    cfg = get_config(arch)
    n = param_count(cfg)
    n_attn = cfg.enc_layers + 2 * cfg.dec_layers
    t0 = time.perf_counter()
    params = bundle_for(cfg).init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    print(f"  on {card_line()}")
    print(f"  {n / 1e9:.3f} B params, {cfg.enc_layers} encoder + {cfg.dec_layers} decoder "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, "
          f"vocab {cfg.vocab}, {cfg.dtype}; init {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    frames = torch.randn((B, F_, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    run = serve_steps(torch, np, dev, cfg, params, B, 1, max_seq, steps,
                      {"flash_attention": n_attn}, {"flash_decode": 2 * cfg.dec_layers},
                      frames=frames)
    print(f"  prefill of {B} x {F_} bf16 frames and one BOS each: "
          f"{B * F_ / run['prefill_s']:.1f} frames/s; " + step_measures(
              torch, cfg, ShapeConfig("p", "prefill", F_, B), run["prefill_s"],
              torch.cuda.max_memory_allocated()))
    print("  decode " + step_measures(torch, cfg, ShapeConfig("d", "decode", max_seq, B),
                                       run["ms_per_step"] / 1e3,
                                       torch.cuda.max_memory_allocated()))
    bos = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    prefill = make_prefill(cfg)
    with attention_launches_by_dtype(torch) as by_dtype:
        prefilled = profile_steps(torch, lambda: prefill(params, {"frames": frames,
                                                                  "tokens": bos},
                                                         max_seq=max_seq),
                                  f"prefill ({B} x {F_} frames)", n=2)
    print(f"  attention launches by dtype over {2 * 2} prefills: {by_dtype}")
    print(f"  teacher-forced logits over {F_} frames, kernel path vs plain path")
    teacher_forced(torch, np, cfg, params, frames=frames[:1])
    del params, frames
    torch.cuda.empty_cache()

    Bt, S = SEAMLESS_TRAIN_RUN[:2]
    per_step = {"flash_attention": n_attn, "flash_attention_bwd": n_attn}
    print("  training on SyntheticLM's frames cast to bf16 on the card (the model, as the "
          "reference's, refuses f32 frames in a bf16 model)")
    gradient_gate(torch, np, dev, cfg, S, {"attention": ref.attention_ref}, per_step,
                  ("enc_blocks.0.attn.wq", "enc_blocks.0.mlp.w_up", "dec_blocks.0.attn.wq",
                   "dec_blocks.0.xattn.wk", f"dec_blocks.{cfg.dec_layers - 1}.xattn.wq",
                   "embed.table", "lm_head.w"), loss_by_token=True)
    torch.cuda.empty_cache()
    trained = train_and_replay(torch, np, dev, cfg, "phase13", SEAMLESS_TRAIN_RUN, per_step)
    print("  " + step_measures(torch, cfg, ShapeConfig("t", "train", S, Bt), trained["step_s"],
                               trained["peak"]))
    state, batch = trained.pop("state"), trained["batch"]
    step_fn = make_train_step(cfg, trained["optimizer"], remat=SEAMLESS_TRAIN_RUN[-1])

    def one_step():
        nonlocal state
        state, metrics = step_fn(state, batch)
        metrics["loss"].item()

    print("  one training step:")
    attention_dtype_gate(torch, one_step, "bfloat16", n_attn)
    served = profile_steps(torch, one_step, f"training step ({Bt} x {S} tokens)",
                           n=TRAIN_PROFILE_STEPS)
    del state
    torch.cuda.empty_cache()
    return {"prefill": {"launches": run["prefill"], "served": prefilled},
            "decode": {"launches": run["decode"], "served": run["served"]},
            "train": {"launches": trained["launches"], "served": served}}


# ---------------------------------------------------------------------------
# phase 14: lidc-100m (examples/train_100m.py) trained in f32
# ---------------------------------------------------------------------------

def lidc_100m_config():
    """The port's copy of examples/train_100m.py's CONFIG_100M."""
    from repro_torch.examples.train_100m import CONFIG_100M
    return CONFIG_100M


def f32_gradient_gate(torch, dev, cfg, seq):
    """The gate batch (GATE_BATCH x ``seq``) through the kernel path (each
    attention kernel launched once a layer, in f32), then twice more with
    loss and gradients bit-equal (``repeat_gate``), and through the plain
    path (``ops.attention`` patched to ``ref.attention_ref``), both f32 on
    the card: the loss and every gradient within LIDC_GRAD_TOL of that
    tensor's largest value (the loss: of its size)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops, ref
    from repro_torch.models import bundle_for
    params = bundle_for(cfg).init(cfg, 0, device=dev).requires_grad_(True)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in next(SyntheticLM(cfg, GATE_BATCH, seq, seed=7)).items()}
    reset_launches()
    print("  the gate batch on the kernel path:")
    loss_k, grads_k = attention_dtype_gate(
        torch, lambda: loss_and_grads(torch, cfg, params, batch), "float32", cfg.n_layers)
    launched = launches_now()
    per_layer = {"flash_attention": cfg.n_layers, "flash_attention_bwd": cfg.n_layers}
    check(all(launched[name] == per_layer.get(name, 0) for name in launched),
          f"kernel path launches {launched}, expected {per_layer}")
    repeat_gate(torch, cfg, params, batch)
    launched = launches_now()
    with mock.patch.object(ops, "attention", ref.attention_ref):
        loss_p, grads_p = loss_and_grads(torch, cfg, params, batch)
    check(launches_now() == launched, "a kernel launched on the plain path")
    errs = {"loss": abs(loss_k - loss_p) / abs(loss_p)}
    for (name, _), gk, gp in zip(params.named_parameters(), grads_k, grads_p):
        errs[name] = float((gk - gp).abs().max() / gp.abs().max())
    top = max(errs, key=errs.get)
    print(f"  gradient gate (batch {GATE_BATCH} x {seq}, f32): loss kernel {loss_k:.7f}, plain "
          f"{loss_p:.7f}; over the loss and {len(grads_k)} gradients the largest max |d| / "
          f"max |plain| {errs[top]:.3e} ({top}; limit {LIDC_GRAD_TOL})")
    for name in sorted(errs, key=errs.get, reverse=True)[:5]:
        print(f"    {name}: {errs[name]:.3e}")
    check(all(e <= LIDC_GRAD_TOL for e in errs.values()),
          f"the kernel path's {top} is off the plain path's: {errs[top]}")
    del params, grads_k, grads_p


def train_lidc_100m(torch, np, dev):
    """Phase 14.  Returns the run's kernel launches and the profiled steps'
    device us per step of each kernel."""
    import gc

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import param_count
    from repro_torch.train.step import make_train_step

    gc.collect()                  # phase 13's lake
    cfg = lidc_100m_config()
    B, S = LIDC_TRAIN_RUN[:2]
    print(f"  on {card_line()}")
    print(f"  {cfg.arch_id} ({cfg.source}): {param_count(cfg) / 1e6:.2f} M params, "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
          f"of {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied embeddings, {cfg.dtype}; "
          f"AdamW moments f32")
    f32_gradient_gate(torch, dev, cfg, S)
    torch.cuda.empty_cache()
    per_step = {"flash_attention": cfg.n_layers, "flash_attention_bwd": cfg.n_layers}
    trained = train_and_replay(torch, np, dev, cfg, "phase14", LIDC_TRAIN_RUN, per_step)
    print("  " + step_measures(torch, cfg, ShapeConfig("t", "train", S, B), trained["step_s"],
                               trained["peak"], f32=True))
    state, batch = trained.pop("state"), trained["batch"]
    step_fn = make_train_step(cfg, trained["optimizer"], remat=LIDC_TRAIN_RUN[-1])

    def one_step():
        nonlocal state
        state, metrics = step_fn(state, batch)
        metrics["loss"].item()

    print("  one training step:")
    attention_dtype_gate(torch, one_step, "float32", cfg.n_layers)
    served = profile_steps(torch, one_step, f"training step ({B} x {S} tokens)",
                           n=TRAIN_PROFILE_STEPS)
    del state
    torch.cuda.empty_cache()
    return {"launches": trained["launches"], "served": served}


# ---------------------------------------------------------------------------
# phase 15: a run that outlives its process (the directory lake)
# ---------------------------------------------------------------------------

def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).iterdir() if f.is_file())


def lake_is_whole(lake_dir):
    """Every object file is named in the index and every ``latest`` pointer
    names a checkpoint whose arrays all read back.  Returns the pointers'
    steps."""
    from repro_torch.lake import DirLake, LakeName
    index = json.loads((Path(lake_dir) / "_index.json").read_text())
    files = {f.name for f in Path(lake_dir).glob("*.bin")}
    check(files == set(index.values()),
          f"{lake_dir}: {len(files)} object files, {len(set(index.values()))} in the index")
    lake, steps = DirLake(str(lake_dir)), {}
    for key in index:
        if key.endswith("/latest"):
            ptr = lake.get_json(LakeName.parse(key))
            name = LakeName.parse(key[:-len("latest")] + f"step={ptr['step']}")
            arrays = lake.get_arrays(name)
            meta = (lake.get_json(name.append("manifest"))
                    or lake.get_json(LakeName.parse(f"{name}#meta")))
            check(arrays is not None and len(arrays) == meta["n"],
                  f"{key} points at step {ptr['step']}, which does not read back whole")
            steps[key] = ptr["step"]
    return steps


def lake_across_processes(torch, np, dev):
    """Phase 15.  ``python -m repro_torch.examples.train_100m`` on a
    directory lake, killed with SIGKILL once its output shows step 5 begun,
    then rerun: it must resume from step 5.  The rerun's losses and its
    step-10 checkpoint against ``run_training`` here, resumed from a copy of
    the directory made right after the kill.  Returns the in-process run's
    kernel launches."""
    import gc
    import shutil
    import tempfile

    import repro_torch.train.trainer as trainer
    from repro_torch.examples.train_100m import CONFIG_100M, LR, RUN_NAME
    from repro_torch.lake import DirLake, LakeName

    B, S, steps, every, kill_at, timeout = LAKE_RUN
    gc.collect()
    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="phase15-"))
    lake_dir, copy_dir = work / "lake", work / "copy"
    cmd = [sys.executable, "-u", "-m", "repro_torch.examples.train_100m", "--lake-dir",
           str(lake_dir), "--steps", str(steps), "--ckpt-every", str(every), "--batch", str(B),
           "--seq", str(S), "--device", dev.type]
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    step_line = re.compile(r"^step\s+(\d+)\s+loss\s+(\S+)$")
    try:
        import threading
        t0 = time.perf_counter()
        with open(work / "first.err", "w") as err:
            first = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=err, text=True, env=env,
                                     cwd=ROOT)
        watchdog = threading.Timer(timeout, first.kill)
        watchdog.start()
        seen = []
        try:
            for line in first.stdout:
                m = step_line.match(line.strip())
                if m:
                    seen.append(int(m.group(1)))
                    if seen[-1] == kill_at:
                        first.kill()     # SIGKILL
                        break
        finally:
            first.kill()
            first.wait(60)
            watchdog.cancel()
        t_first = time.perf_counter() - t0
        check(seen and seen[-1] == kill_at, f"the first process printed steps {seen}, not step "
              f"{kill_at}: {(work / 'first.err').read_text()[-2000:]}")
        shutil.copytree(lake_dir, copy_dir)
        killed = lake_is_whole(lake_dir)
        ckpt = LakeName.parse("/lidc/data/ckpt").append(RUN_NAME)
        print(f"  process 1: killed (exit {first.returncode}) after printing step {kill_at}, "
              f"{t_first:.1f} s; latest {killed}; {dir_bytes(lake_dir) / 2**30:.3f} GiB on disk")
        check(list(killed.values()) == [every] and not DirLake(str(lake_dir)).has(
            ckpt.append(f"step={steps}")), f"after the kill: latest {killed}")

        t0 = time.perf_counter()
        second = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env,
                                cwd=ROOT)
        t_second = time.perf_counter() - t0
        check(second.returncode == 0, f"the second process failed: {second.stderr[-2000:]}")
        rerun = [step_line.match(l.strip()) for l in second.stdout.splitlines()]
        rerun = [(int(m.group(1)), float(m.group(2))) for m in rerun if m]
        print(f"  process 2: {t_second:.1f} s, steps {[s_ for s_, _ in rerun]}; "
              f"{'resumed from step 5' if f'resumed from step {every}' in second.stdout else ''}")
        check(f"(resumed from step {every} via named checkpoint)" in second.stdout,
              "the second process did not say it resumed from step 5")

        timings = {"save": [], "restore": []}

        def timed(fn, what):
            def call(*args, **kw):
                t = time.perf_counter()
                out = fn(*args, **kw)
                timings[what].append(time.perf_counter() - t)
                return out
            return call

        reset_launches()
        t0 = time.perf_counter()
        save, restore = (timed(trainer.save_checkpoint, "save"),
                         timed(trainer.restore_checkpoint, "restore"))
        with mock.patch.object(trainer, "save_checkpoint", save), \
                mock.patch.object(trainer, "restore_checkpoint", restore):
            res = trainer.run_training(CONFIG_100M, steps=steps, batch=B, seq=S,
                                       lake=DirLake(str(copy_dir)), run_name=RUN_NAME,
                                       ckpt_every=every, lr=LR, device=dev)
        torch.cuda.synchronize()
        t_here = time.perf_counter() - t0
        launches = launches_now()
        print(f"  here, from the copy: resumed from {res.resumed_from}, {t_here:.1f} s; "
              f"launches {launches}")
        print(f"  losses, process 2: {[l for _, l in rerun]}; here: {res.losses}")
        check(res.resumed_from == every and [s_ for s_, _ in rerun] == list(range(every, steps)),
              f"resumed from {res.resumed_from}; process 2's steps {rerun}")
        check([np.float32(l) for _, l in rerun] == [np.float32(l) for l in res.losses],
              "process 2's losses differ from the in-process resume's")
        n = steps - every
        want = {"flash_attention": n * CONFIG_100M.n_layers,
                "flash_attention_bwd": n * CONFIG_100M.n_layers}
        check(all(launches[k] == want.get(k, 0) for k in launches),
              f"launches {launches}, expected {want}")
        res.state = None
        gc.collect()
        a = DirLake(str(lake_dir)).get_arrays(ckpt.append(f"step={steps}"))
        b = DirLake(str(copy_dir)).get_arrays(ckpt.append(f"step={steps}"))
        moved = [k for k in b if not np.array_equal(a.get(k), b[k])]
        print(f"  step-{steps} checkpoints: {len(b)} arrays, {len(moved)} differ")
        check(a is not None and set(a) == set(b) and not moved,
              f"the step-{steps} checkpoints differ: {moved[:5]}")
        for d in (lake_dir, copy_dir):
            check(list(lake_is_whole(d).values()) == [steps], f"{d}: latest is not {steps}")
        print(f"  checkpoint write {timings['save']} s, read {timings['restore']} s "
              f"({sum(v.nbytes for v in b.values()) / 2**30:.3f} GiB of arrays); "
              f"{dir_bytes(lake_dir) / 2**30:.3f} GiB on disk (two checkpoints)")
        del a, b
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phase 16: the collectives, two ranks on the one card
# ---------------------------------------------------------------------------

def _rank_report(tmp, rank, report) -> None:
    import pickle
    with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(report, f)


def _nccl_probe_rank(rank, n, tmp):
    """Two ranks on cuda:0 under NCCL: one all_reduce.  Reports its result or
    the error NCCL raises."""
    import os

    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    try:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=rank,
                                world_size=n)
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        report = {"ok": bool(t[0].item() == n), "error": None}
    except Exception as exc:      # the probe's finding, reported to the parent
        report = {"ok": False, "error": f"{type(exc).__name__}: {exc}"[:600]}
    _rank_report(tmp, rank, report)
    os._exit(0)                   # no teardown of a communicator that may be broken


def _gloo_takes(torch, dist, rank, n, dev, tmp):
    """Which collectives gloo runs on CUDA tensors here: name -> True or the
    error it raises, each also appended to ``tmp``/takes<rank>.txt as it
    ends (a collective that aborts the process leaves the ones before it).
    Send and recv are probed apart (``_p2p_probe_rank``)."""
    out = {}
    probes = {
        "all_reduce": lambda: dist.all_reduce(torch.ones(8, device=dev)),
        "all_gather": lambda: dist.all_gather([torch.empty(8, device=dev) for _ in range(n)],
                                              torch.ones(8, device=dev)),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(8 * n, device=dev), torch.ones(8 * n, device=dev)),
        "all_to_all_single uneven": lambda: dist.all_to_all_single(   # 4 from rank 0 to 1
            torch.empty(4 if rank else 0, device=dev), torch.ones(0 if rank else 4, device=dev),
            [4, 0] if rank else [0, 0], [0, 0] if rank else [0, 4]),
        "int8 all_gather": lambda: dist.all_gather(
            [torch.empty(8, dtype=torch.int8, device=dev) for _ in range(n)],
            torch.ones(8, dtype=torch.int8, device=dev)),
    }
    for name, fn in probes.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = True
        except Exception as exc:     # the probe's finding
            out[name] = f"{type(exc).__name__}: {exc}"[:300]
        with open(Path(tmp) / f"takes{rank}.txt", "a") as f:
            f.write(f"{name}: {out[name]}\n")
    return out


def _p2p_probe_rank(rank, n, tmp):
    """Two gloo ranks on cuda:0: isend and recv of a CUDA tensor.  Reports
    what it got, if the process lives."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=n)
    try:
        got = torch.zeros(8, device="cuda")
        req = dist.isend(torch.full((8,), float(rank + 1), device="cuda"), dst=1 - rank)
        dist.recv(got, src=1 - rank)
        req.wait()
        report = {"ok": bool(got[0].item() == 2 - rank), "error": None}
    except Exception as exc:      # the probe's finding
        report = {"ok": False, "error": f"{type(exc).__name__}: {exc}"[:300]}
    _rank_report(tmp, rank, report)
    __import__("os")._exit(0)


def _rel(torch, got, want):
    return float((got - want).detach().abs().max() / want.detach().abs().max())


def _ep_check(torch, rank, dev):
    """qwen3-moe-30b-a3b's MoE block (full width, f32) expert parallel over
    a 1 x 2 ("data", "model") mesh against the block on one rank."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import rules_for
    from repro_torch.models import moe
    from repro_torch.models.sharding import use_mesh, use_rules
    from torch.distributed.device_mesh import init_device_mesh

    B, S = EP_RUN
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    full = moe.init_moe(cfg, 0, device=dev).requires_grad_(True)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev).requires_grad_(True)
    gy = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
    names = ("router", "w_gate", "w_up", "w_down")
    routed = []
    router = ops.moe_router

    def recording(*args, **kw):
        out = router(*args, **kw)
        routed.append(out[1].detach().clone())
        return out

    def run(p):
        with mock.patch.object(ops, "moe_router", recording):
            y, aux = moe.moe_block(cfg, p, x)
        grads = torch.autograd.grad(torch.sum(y * gy) + 3.0 * aux,
                                    [x] + [getattr(p, k) for k in names])
        torch.cuda.synchronize()
        return y.detach(), aux.item(), grads

    y1, aux1, g1 = run(full)
    mesh = init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "model"))
    rules = rules_for(cfg, model_axis=2)
    with use_rules(rules), use_mesh(mesh):
        p = moe.local_experts(cfg, full)
        reset_launches()
        t0 = time.perf_counter()
        y2, aux2, g2 = run(p)
        t_sharded = time.perf_counter() - t0
        launched = launches_now()
    E_loc = cfg.n_experts // 2
    want = [g1[0], g1[1]] + [g[rank * E_loc:(rank + 1) * E_loc] for g in g1[2:]]
    return {"mode": "expert parallel" if rules["expert"] else "expert TP",
            "experts": tuple(p.w_gate.shape), "y": _rel(torch, y2, y1),
            "aux": abs(aux2 - aux1) / abs(aux1), "aux_values": (aux1, aux2),
            "grads": dict(zip(("x",) + names, (_rel(torch, a, b) for a, b in zip(g2, want)))),
            "ids_equal": bool(torch.equal(routed[0], routed[1])),
            "launches": {k: v for k, v in launched.items() if v}, "s": t_sharded,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def _pp_check(torch, dev):
    """lidc-100m as 2 GPipe stages of 5 layers against the sequential
    loss_fn on the card."""
    from repro_torch.data import SyntheticLM
    from repro_torch.examples.train_100m import CONFIG_100M as cfg
    from repro_torch.models import bundle_for
    from repro_torch.runtime.pipeline import make_pp_loss_fn, make_pp_mesh, stage_layers

    B, S, n_micro = PP_RUN
    params = bundle_for(cfg).init(cfg, 0, device=dev).requires_grad_(True)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in next(SyntheticLM(cfg, B, S, seed=7)).items()}
    mesh = make_pp_mesh(2)
    layers = stage_layers(cfg, mesh, 2)
    named = [(name, p) for name, p in params.named_parameters()
             if not name.startswith("blocks.") or int(name.split(".")[1]) in layers]
    seq = bundle_for(cfg).loss_fn(cfg, params, batch)
    want = torch.autograd.grad(seq, [p for _, p in named])
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = make_pp_loss_fn(cfg, mesh, n_stages=2, n_micro=n_micro)(params, batch)
    got = torch.autograd.grad(loss, [p for _, p in named])
    torch.cuda.synchronize()
    errs = {name: _rel(torch, a, b) for (name, _), a, b in zip(named, got, want)}
    top = max(errs, key=errs.get)
    return {"layers": list(layers), "loss": (loss.item(), seq.item()),
            "loss_err": abs(loss.item() - seq.item()) / abs(seq.item()),
            "worst": (top, errs[top]), "n_grads": len(errs),
            "launches": {k: v for k, v in launches_now().items() if v},
            "s": time.perf_counter() - t0,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def _pod_check(torch, dist, rank, dev):
    """lidc-100m's train step with compress_pods over 2 pods: the first
    step's gradient against the plain all-reduce sum, the int8 payload, and
    the whole run twice."""
    import numpy as np
    from repro_torch.data import SyntheticLM
    from repro_torch.examples.train_100m import CONFIG_100M as cfg
    from repro_torch.examples.train_100m import LR
    from repro_torch.models import bundle_for
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.optim.compress import compressed_psum_pod
    from repro_torch.train.step import make_train_state, make_train_step
    from torch.distributed.device_mesh import init_device_mesh

    rows, S, steps = POD_RUN
    mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("pod",))
    pod = mesh.get_group("pod")
    stream = SyntheticLM(cfg, 2 * rows, S, seed=0)
    batches = [{k: torch.from_numpy(v[rank * rows:(rank + 1) * rows]).to(dev)
                for k, v in next(stream).items()} for _ in range(steps)]
    optimizer = AdamW(lr=warmup_cosine(LR, max(steps // 20, 2), steps))

    # the first step's gradient: compressed against the plain sum
    state = make_train_state(cfg, 0, optimizer, device=dev)
    leaves = list(state["params"].parameters())
    grads = torch.autograd.grad(bundle_for(cfg).loss_fn(cfg, state["params"], batches[0]),
                                leaves)
    wire = []

    def recording(fn):
        def call(out, inp, *args, **kw):      # the tensor this rank hands over
            wire.append((inp.dtype, inp.numel()))
            return fn(out, inp, *args, **kw)
        return call

    with mock.patch.object(dist, "all_to_all_single", recording(dist.all_to_all_single)), \
            mock.patch.object(dist, "all_gather", recording(dist.all_gather)):
        comp = [compressed_psum_pod(g, pod) for g in grads]
    worst = 0.0
    for g, c in zip(grads, comp):
        plain = g.clone()
        dist.all_reduce(plain, group=pod)
        scales = torch.empty(2, device=dev)
        dist.all_gather(list(scales.view(2, 1)), (g.abs().max() / 127.0).reshape(1))
        s2 = (plain.abs().max() + scales.sum() / 2) / 127.0
        bound = scales.sum() / 2 + s2 / 2 + 1e-6 * plain.abs().max()
        worst = max(worst, float((c - plain).abs().max() / bound))
    payload = [(dtype, numel) for dtype, numel in wire if numel > 1]   # all but the scales
    int8_bytes = sum(numel for dtype, numel in payload if dtype == torch.int8)
    scale_bytes = sum(numel * 4 for dtype, numel in wire if numel == 1)
    del state, grads, comp

    def run():
        state = make_train_state(cfg, 0, optimizer, device=dev)
        step = make_train_step(cfg, optimizer, compress_pods=True, mesh=mesh)
        losses = []
        for b in batches:
            state, metrics = step(state, b)
            losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        return losses, state_fingerprints(torch, state)

    t0 = time.perf_counter()
    losses, fps = run()
    t_run = time.perf_counter() - t0
    again, fps_again = run()
    return {"grad_bound_ratio": worst,
            "payload_int8": all(dtype == torch.int8 for dtype, _ in payload),
            "int8_bytes": int8_bytes, "f32_bytes": 4 * int8_bytes, "scale_bytes": scale_bytes,
            "collectives_per_step": len(wire), "losses": losses,
            "repeat_equal": losses == again and fps == fps_again,
            "finite": bool(np.all(np.isfinite(losses))), "s_per_step": t_run / steps}


def _phase16_rank(rank, n, tmp, backend):
    """One of the two ranks of phase 16 on cuda:0."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", rank=rank,
                            world_size=n)
    report = {}
    try:
        report["takes"] = (_gloo_takes(torch, dist, rank, n, dev, tmp) if backend == "gloo"
                           else {})
        report["ep"] = _ep_check(torch, rank, dev)
        torch.cuda.empty_cache()
        report["pp"] = _pp_check(torch, dev)
        torch.cuda.empty_cache()
        report["pod"] = _pod_check(torch, dist, rank, dev)
    except Exception:      # reported to the parent, which fails the phase
        import traceback
        report["error"] = traceback.format_exc()[-3000:]
    _rank_report(tmp, rank, report)
    __import__("os")._exit(0)     # no teardown: the parent has the report


def spawn_ranks(fn, n, timeout, *args):
    """``fn(rank, n, tmp, *args)`` on n processes (spawn); each writes its
    report.  Returns the reports (None for a rank that wrote none), the exit
    codes and ``tmp``; kills every process still running at ``timeout``."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="ranks-")
    ctx = mp.start_processes(fn, args=(n, tmp) + args, nprocs=n, join=False,
                             start_method="spawn")
    deadline = time.perf_counter() + timeout
    procs = ctx.processes
    for p in procs:
        p.join(max(deadline - time.perf_counter(), 0.1))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(30)
    reports = []
    for r in range(n):
        path = Path(tmp) / f"rank{r}.pkl"
        reports.append(pickle.loads(path.read_bytes()) if path.exists() else None)
    return reports, [p.exitcode for p in procs], tmp


def collectives(torch):
    """Phase 16.  Returns each rank's launches on the EP and GPipe paths."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    probe, codes, _ = spawn_ranks(_nccl_probe_rank, 2, 120)
    nccl_ok = all(r is not None and r["ok"] for r in probe)
    print(f"  NCCL, two ranks on cuda:0: {'takes them' if nccl_ok else 'refuses'} "
          f"(exit codes {codes}; {[r and r['error'] for r in probe]}); "
          f"{time.perf_counter() - t0:.1f} s")
    backend = "nccl" if nccl_ok else "gloo"
    t0 = time.perf_counter()
    reports, codes, tmp = spawn_ranks(_phase16_rank, 2, RANKS_TIMEOUT, backend)
    print(f"  backend {backend}: two ranks on cuda:0, {time.perf_counter() - t0:.1f} s "
          f"(exit codes {codes})")
    for r, rep in enumerate(reports):
        takes = Path(tmp) / f"takes{r}.txt"
        check(rep is not None and "error" not in rep,
              f"rank {r}: {rep and rep.get('error')} (exit code {codes[r]}; collectives "
              f"probed: {takes.read_text() if takes.exists() else 'none'})")
    if backend == "gloo":
        print(f"  gloo on CUDA tensors: {reports[0]['takes']}")
        t0 = time.perf_counter()
        p2p, codes, _ = spawn_ranks(_p2p_probe_rank, 2, 120)
        print(f"  gloo isend/recv of a CUDA tensor: reports {p2p}, exit codes {codes} "
              f"(-6: the process aborted); {time.perf_counter() - t0:.1f} s")
    out = {}
    for r, rep in enumerate(reports):
        ep, pp, pod = rep["ep"], rep["pp"], rep["pod"]
        print(f"  rank {r} EP ({ep['mode']}, experts {ep['experts']}): y {ep['y']:.3e}, aux "
              f"{ep['aux']:.3e} {ep['aux_values']}, gradients {ep['grads']}; routing ids equal "
              f"{ep['ids_equal']}; launches {ep['launches']}; {ep['s']:.2f} s, peak (both "
              f"blocks) {ep['peak_gib']:.2f} GiB")
        check(ep["y"] <= LIDC_GRAD_TOL and ep["aux"] <= LIDC_GRAD_TOL
              and max(ep["grads"].values()) <= LIDC_GRAD_TOL, f"rank {r}: EP off the one rank")
        check(ep["ids_equal"], f"rank {r}: EP routed other experts")
        check(ep["launches"] == {"moe_router": 1, "moe_router_bwd": 1},
              f"rank {r}: EP launches {ep['launches']}")
        print(f"  rank {r} GPipe (layers {pp['layers']}): loss {pp['loss']}, off by "
              f"{pp['loss_err']:.3e}; worst of {pp['n_grads']} gradients {pp['worst']}; "
              f"launches {pp['launches']}; {pp['s']:.2f} s, peak {pp['peak_gib']:.2f} GiB")
        per = PP_RUN[2] * len(pp["layers"])
        check(pp["loss_err"] <= LIDC_GRAD_TOL and pp["worst"][1] <= LIDC_GRAD_TOL,
              f"rank {r}: GPipe off the sequential loss_fn")
        check(pp["launches"] == {"flash_attention": per, "flash_attention_bwd": per},
              f"rank {r}: GPipe launches {pp['launches']}, expected {per} + {per}")
        print(f"  rank {r} compressed step: first gradient at {pod['grad_bound_ratio']:.3f} of "
              f"the two roundings' bound; int8 payload {pod['payload_int8']}, "
              f"{pod['int8_bytes']} B handed over against {pod['f32_bytes']} B in f32, plus "
              f"{pod['scale_bytes']} B of scales "
              f"({pod['collectives_per_step']} collectives a step); losses {pod['losses']}; "
              f"repeat bit-equal {pod['repeat_equal']}; {1e3 * pod['s_per_step']:.1f} ms a step")
        check(pod["grad_bound_ratio"] <= 1.0, f"rank {r}: compressed gradient off its bound")
        check(pod["payload_int8"], f"rank {r}: a payload that is not int8")
        check(pod["repeat_equal"], f"rank {r}: the compressed run differs when run again")
        check(pod["finite"] and pod["losses"][-1] < pod["losses"][0],
              f"rank {r}: losses not finite and falling")
        out[r] = {"ep": ep["launches"], "pp": pp["launches"]}
    check(reports[0]["pod"]["losses"] == reports[1]["pod"]["losses"],
          "the pods' averaged losses differ")
    return out


# ---------------------------------------------------------------------------
# phase 7: the kernel table at serving shapes
# ---------------------------------------------------------------------------

def kernel_table(torch, dev, dense, prompt_lengths, hybrid, moe):
    """One row per kernel and serving shape.  ``dense``, ``hybrid`` and
    ``moe`` hold the launches and the served decode steps' device us per
    kernel of phases 3, 5 and 6.  Each kernel is timed twice: L2 flushed by
    writing 256 MB ("ms", which leaves it full of dirty lines), and by
    reading them ("ms_read_flush", clean lines, as a served layer finds the
    last layer's weights)."""
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                     flash_attention_fwd)
    from repro_torch.kernels.moe_gating import (moe_gating, moe_router, moe_router_bwd,
                                                moe_router_fwd)
    from repro_torch.kernels.ssd_scan import (ssd_state_scan, ssd_state_scan_bwd,
                                              ssd_state_scan_fwd)

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    bf16 = torch.bfloat16
    buf = torch.empty(64 << 20, dtype=torch.float32, device=dev)   # 256 MB > L2
    flush, read_flush = buf.zero_, buf.sum
    rows = []

    def randn(shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def library_ms(fn):
        try:
            return time_ms(torch, fn, flush)
        except (TypeError, RuntimeError) as exc:   # e.g. a torch without enable_gqa
            print(f"  library call unavailable: {exc}")
            return None

    one = torch.zeros(1, device=dev)
    floor = (time_ms(torch, lambda: one.add_(1), flush),
             time_ms(torch, lambda: one.add_(1), read_flush))
    print(f"  launch floor: a one-element PyTorch op (add_) takes {floor[0]:.5f} / "
          f"{floor[1]:.5f} ms with L2 flushed by writing / by reading")

    def add(name, source, replaces, shape, launches, kernel, plain, flops, nbytes, dtype,
            library, tol, compare=None, served=None, **extra):
        out, want = kernel(), plain()
        if compare is None:
            err, ok = max_err(out, want, tol)
        else:
            err, ok = compare(out, want)
        check(ok, f"{name} disagrees with its plain version at {shape}: {err}")
        bound, by = bound_of(flops, nbytes, dtype)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "shape": shape, "launches": launches,
            "max_abs_err": err, "ms": time_ms(torch, kernel, flush),
            "ms_read_flush": time_ms(torch, kernel, read_flush),
            "plain_ms": time_ms(torch, plain, flush), "bound_ms": bound, "bound_by": by,
            "library_ms": None if library is None else library_ms(library),
            "served_us_per_step": served, "launch_floor_ms": floor[0], **extra,
        })

    def attention_row(model, B, S, H, K, hd, launches, what="prefill layer",
                      dtype_name="bfloat16", causal=True, **extra):
        dtype = getattr(torch, dtype_name)
        q, k, v = (randn((B, S, H, hd), dtype), randn((B, S, K, hd), dtype),
                   randn((B, S, K, hd), dtype))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = S * (S + 1) // 2 if causal else S * S     # (query, key) pairs
        add("flash_attention", "flash_attention.cu", "src/repro/kernels/flash_attention.py:94",
            f"{model} {what}: B={B} S={S} H={H} K={K} hd={hd} {dtype_name} "
            f"{'causal' if causal else 'non-causal'}", launches,
            lambda: flash_attention(q, k, v, causal=causal),
            lambda: ref.attention_ref(q, k, v, causal=causal),
            4.0 * B * H * hd * pairs, q.element_size() * (2 * q.numel() + k.numel() + v.numel()),
            dtype_name, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), TOL[dtype_name], **extra)

    def decode_row(model, B, Smax, H, K, hd, lens, launches, served, what="decode layer",
                   **extra):
        q = randn((B, 1, H, hd))
        ck, cv = randn((2, B, Smax, K, hd))[1], randn((2, B, Smax, K, hd))[1]
        if isinstance(lens, list):
            length = torch.tensor(lens, dtype=torch.int32, device=dev)
        else:                                     # one 0-dim length, as a lockstep batch
            length, lens = torch.tensor(lens, dtype=torch.int32, device=dev), [lens] * B
        valid = torch.arange(Smax, device=dev)[None, :] < length.reshape(-1, 1)
        mask = valid.expand(B, Smax)[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2)
        add("flash_decode", "decode_attention.cu", "src/repro/kernels/decode_attention.py:85",
            f"{model} {what}: B={B} Smax={Smax} H={H} K={K} hd={hd} bf16 "
            f"lengths={lens if len(set(lens)) > 1 else lens[0]}", launches,
            lambda: flash_decode(q, ck, cv, length),
            lambda: ref.decode_attention_ref(q, ck, cv, length),
            4.0 * H * hd * sum(lens), 2.0 * (2 * K * hd * sum(lens) + 2 * q.numel())
            + 4 * length.numel(), "bfloat16",
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                   enable_gqa=True), TOL["bfloat16"],
            served=served, **extra)

    def bwd_row(model, B, S, H, K, hd, dtype_name="bfloat16", causal=True, launches=None,
                **extra):
        dtype = getattr(torch, dtype_name)
        q, k, v, do = (randn((B, S, H, hd), dtype), randn((B, S, K, hd), dtype),
                       randn((B, S, K, hd), dtype), randn((B, S, H, hd), dtype))
        o, lse = flash_attention_fwd(q, k, v, causal=causal, with_lse=True)
        leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=True)
        dot = do.transpose(1, 2)
        pairs = S * (S + 1) // 2 if causal else S * S

        def compare(out, want):
            tol = TOL[dtype_name]
            errs = [max_err(g, w, tol) for g, w in zip(out, want)]
            rels = [grad_row_rel_err(g, w, tol) for g, w in zip(out, want)]
            return (max(e for e, _ in errs), all(ok for _, ok in errs) and all(
                r is None or r <= GRAD_ROW_TOL[dtype_name] for r in rels))

        # bytes: q, k, v, o, dO and lse read once; dq, dk, dv written once
        add("flash_attention_bwd", "flash_attention_bwd_sm90.cu" if dtype == bf16
            else "flash_attention_bwd.cu", "src/repro/kernels/flash_attention.py:94",
            f"{model} training layer: B={B} S={S} H={H} K={K} hd={hd} {dtype_name} "
            f"{'causal' if causal else 'non-causal'}", launches,
            lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=causal),
            lambda: ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal),
            10.0 * B * H * hd * pairs,
            q.element_size() * (4 * q.numel() + 4 * k.numel()) + 4.0 * lse.numel(),
            dtype_name, lambda: torch.autograd.grad(sdpa_out, leaves, dot, retain_graph=True),
            None, compare,
            counterpart="the reference differentiates ref.attention_ref with XLA's autodiff; "
                        "no Pallas backward", **extra)

    def router_row(T, D, E, k, launches, phase, served):
        x = randn((T, D))
        router = torch.randn((D, E), generator=gen, device=dev) * D ** -0.5

        def compare(out, want):
            r = check_router_output(torch, out, want, E, exact_ids=False)
            return max(r["err_w"], r["err_p"]), r["ok"]

        def chain():
            return router_chain(x, router, k)

        add("moe_router", "moe_gating.cu", "src/repro/kernels/moe_gating.py:55",
            f"qwen3-moe-30b-a3b {phase} router: T={T} D={D} E={E} k={k} x bf16, router f32",
            launches, lambda: moe_router(x, router, k), lambda: ref.moe_router_ref(x, router, k),
            2.0 * T * D * E + T * E * (4.0 + 2 * k),
            2.0 * T * D + 4.0 * D * E + 8.0 * T * k + 4.0 * T * E, "float32", None, None,
            compare, served, chain_ms=time_ms(torch, chain, flush),
            chain_ms_read_flush=time_ms(torch, chain, read_flush))

    def gating_row(T, E, k, launches, phase):
        x = torch.randn((T, E), generator=gen, device=dev)

        def compare(out, want):
            err, ok = max_err(out[0], want[0], TOL["float32"])
            return err, ok and bool(torch.equal(out[1], want[1]))

        add("moe_gating", "moe_gating.cu", "src/repro/kernels/moe_gating.py:55",
            f"qwen3-moe-30b-a3b {phase} router on f32 logits: T={T} E={E} k={k}", launches,
            lambda: moe_gating(x, k), lambda: ref.moe_gating_ref(x, k),
            T * E * (4.0 + 2 * k), 4.0 * T * E + 8.0 * T * k, "float32", None, None, compare)

    def router_bwd_row(T, D, E, k):
        x = randn((T, D))
        router = torch.randn((D, E), generator=gen, device=dev) * D ** -0.5
        w, ids, probs = moe_router_fwd(x, router, k)
        gw = torch.randn((T, k), generator=gen, device=dev)
        gprobs = torch.randn((T, E), generator=gen, device=dev) / T
        dlogits = moe_router_bwd(gw, gprobs, w, ids, probs)

        def compare(out, want):
            (err,), _, ok = grads_close([out], [want], ["float32"])
            return err, ok

        def products():        # as the op's backward runs them after the kernel
            return (dlogits @ router.T).to(x.dtype), x.float().T @ dlogits

        # bytes: probs, gprobs, gw, w and ids read once, dlogits written once
        add("moe_router_bwd", "moe_router_bwd.cu", "src/repro/kernels/moe_gating.py:55",
            f"qwen3-moe-30b-a3b training router backward (phase 10): T={T} E={E} k={k} f32, "
            f"gprobs present", None, lambda: moe_router_bwd(gw, gprobs, w, ids, probs),
            lambda: ref.moe_router_bwd_ref(gw, gprobs, w, ids, probs),
            7.0 * T * E + 6.0 * T * k, 12.0 * T * E + 12.0 * T * k, "float32", None, None,
            compare, counterpart="the gradient of moe_router; the reference differentiates "
                                 "ref.moe_gating_ref and the product with XLA; no Pallas "
                                 "backward",
            products_ms=time_ms(torch, products, flush),
            products_ms_read_flush=time_ms(torch, products, read_flush))

    def scan_row(B, C, H, P, N, launches, phase):
        xs = torch.randn((B, C, H, P, N), generator=gen, device=dev)
        a = torch.rand((B, C, H), generator=gen, device=dev) * 0.69 + 0.3

        def compare(out, want):
            (ep, okp), (ef, okf) = (max_err(o, w, TOL["float32"]) for o, w in zip(out, want))
            return max(ep, ef), okp and okf

        add("ssd_state_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:62",
            f"zamba2-2.7b {phase} Mamba2 block: B={B} C={C} H={H} P={P} N={N} f32", launches,
            lambda: ssd_state_scan(xs, a), lambda: ref.ssd_state_scan_ref(xs, a),
            2.0 * xs.numel(), 4.0 * (2 * xs.numel() + a.numel() + B * H * P * N),
            "float32", None, None, compare)

    def scan_bwd_row(B, C, H, P, N):
        """As the model calls it: no initial state, the final state unread."""
        a = torch.rand((B, C, H), generator=gen, device=dev) * 0.69 + 0.3
        prefix, _ = ssd_state_scan_fwd(torch.randn((B, C, H, P, N), generator=gen, device=dev),
                                       a)
        gp = torch.randn((B, C, H, P, N), generator=gen, device=dev)

        def compare(out, want):
            return scan_bwd_close(out, want, prefix)

        # bytes: g_prefix and prefix read, d_states written, the decays read
        # and d_decays written
        add("ssd_state_scan_bwd", "ssd_scan_bwd.cu", "src/repro/kernels/ssd_scan.py:62",
            f"zamba2-2.7b training Mamba2 block (phase 11): B={B} C={C} H={H} P={P} N={N} "
            f"f32, no initial state, the final state unread", None,
            lambda: ssd_state_scan_bwd(gp, None, prefix, a, False),
            lambda: ref.ssd_state_scan_bwd_ref(gp, None, prefix, a, False),
            4.0 * gp.numel(), 4.0 * (3 * gp.numel() + 2 * a.numel()), "float32", None, None,
            compare, counterpart="the gradient of ssd_state_scan; the reference "
                                 "differentiates ref.ssd_state_scan_ref with XLA; no Pallas "
                                 "backward")

    # qwen3-1.7b (phase 3): one prefill layer at S = 1024; one decode layer,
    # 8 slots, the serving run's first eight prompts half-way through their
    # 32 new tokens
    q17 = get_config(SERVE_ARCH)
    attention_row(SERVE_ARCH, 1, 1024, q17.n_heads, q17.n_kv_heads, q17.hd,
                  dense["launches"]["flash_attention"])
    decode_row(SERVE_ARCH, MAX_BATCH, MAX_SEQ, q17.n_heads, q17.n_kv_heads, q17.hd,
               [n + MAX_NEW // 2 for n in prompt_lengths[:MAX_BATCH]],
               dense["launches"]["flash_decode"], dense["served"]["flash_decode"])
    # zamba2-2.7b (phase 5): its shared block at head dim 80; the state scan
    # of one Mamba2 block's prefill
    arch, B, S, max_seq, steps = HYBRID_RUN
    z = get_config(arch)
    attention_row(arch, B, S, z.n_heads, z.n_kv_heads, z.hd,
                  hybrid["prefill"]["flash_attention"])
    decode_row(arch, B, max_seq, z.n_heads, z.n_kv_heads, z.hd, S + steps // 2,
               hybrid["decode"]["flash_decode"], hybrid["served"]["flash_decode"])
    d_inner = z.ssm_expand * z.d_model
    scan_row(B, -(-S // z.chunk), z.ssm_heads, d_inner // z.ssm_heads, z.ssm_state,
             hybrid["prefill"]["ssd_state_scan"], "prefill")
    # qwen3-moe-30b-a3b (phase 6): one prefill and one decode layer at group
    # 8; the router at prefill and at decode
    arch, B, S, max_seq, steps = MOE_RUN
    m = get_config(arch)
    attention_row(arch, B, S, m.n_heads, m.n_kv_heads, m.hd, moe["prefill"]["flash_attention"])
    decode_row(arch, B, max_seq, m.n_heads, m.n_kv_heads, m.hd, S + steps // 2,
               moe["decode"]["flash_decode"], moe["served"]["flash_decode"])
    router_row(B * S, m.d_model, m.n_experts, m.top_k, moe["prefill"]["moe_router"],
               "prefill", None)
    router_row(B, m.d_model, m.n_experts, m.top_k, moe["decode"]["moe_router"], "decode",
               moe["served"]["moe_router"])
    gating_row(B * S, m.n_experts, m.top_k, moe["prefill"]["moe_gating"], "prefill")
    gating_row(B, m.n_experts, m.top_k, moe["decode"]["moe_gating"], "decode")
    # mistral-large-123b (phase 17): one decode layer at group 12 (96 query
    # heads over 8 KV heads); its launches and device us per step are phase
    # 17's, filled in there
    arch, _, B, S, max_seq, steps = MISTRAL_RUN
    ml = get_config(arch)
    decode_row(arch, B, max_seq, ml.n_heads, ml.n_kv_heads, ml.hd, S + steps // 2, None, None,
               phase17=True)
    # qwen3-1.7b training (phase 8): one layer's attention backward; its
    # launches and device us per step are phase 8's, filled in there
    arch, B, S = TRAIN_RUN[:3]
    t = get_config(arch)
    bwd_row(arch, B, S, t.n_heads, t.n_kv_heads, t.hd)
    # qwen3-moe-30b-a3b training (phase 10): the router backward of one
    # layer; its launches and device us per step are phase 10's
    B, S = MOE_TRAIN_RUN[2:4]
    router_bwd_row(B * S, m.d_model, m.n_experts, m.top_k)
    # zamba2-2.7b training (phase 11): the state scan and its reverse of one
    # Mamba2 block; their launches and device us per step are phase 11's
    B, S = HYBRID_TRAIN_RUN[1:3]
    scan_shape = (B, -(-S // z.chunk), z.ssm_heads, d_inner // z.ssm_heads, z.ssm_state)
    scan_row(*scan_shape, None, "training (phase 11)")
    scan_bwd_row(*scan_shape)
    # seamless-m4t-large-v2 (phase 13), head dim 64, group 1: an encoder
    # layer (serving; and training, where its 72 launches a step are of
    # this shape but the decoder's 24 causal ones), the cross-attention's
    # decode against the 0-dim encoder length, and the training layer's
    # backward; their launches and device us a prefill, a decode step or a
    # training step are phase 13's, filled in there
    e = get_config(SEAMLESS_SERVE[0])
    B, F_ = SEAMLESS_SERVE[1:3]
    attention_row(e.arch_id, B, F_, e.n_heads, e.n_kv_heads, e.hd, None,
                  "encoder layer (phase 13)", causal=False, phase13="prefill", per="prefill")
    attention_row(e.arch_id, B, F_, e.n_heads, e.n_kv_heads, e.hd, None,
                  "training encoder layer (phase 13)", causal=False, phase13="train")
    decode_row(e.arch_id, B, F_, e.n_heads, e.n_kv_heads, e.hd, F_, None, None,
               "cross-attention decode layer (phase 13)", phase13="decode")
    B, S = SEAMLESS_TRAIN_RUN[:2]
    bwd_row(f"{e.arch_id} (phase 13)", B, S, e.n_heads, e.n_kv_heads, e.hd, causal=False,
            phase13="train")
    # f32, A and A' on the CUDA cores: seamless's encoder layer (no path
    # runs it in f32: phase 13 trains in bf16) and a lidc-100m training
    # layer, whose launches and device us a step are phase 14's, filled in
    # there
    attention_row(e.arch_id, B, F_, e.n_heads, e.n_kv_heads, e.hd, 0, "encoder layer in f32",
                  dtype_name="float32", causal=False, per="call (no path runs it in f32)")
    bwd_row(f"{e.arch_id} encoder", B, F_, e.n_heads, e.n_kv_heads, e.hd,
            dtype_name="float32", causal=False, per="call (no path runs it in f32)",
            launches=0)
    lidc = lidc_100m_config()
    B, S = LIDC_TRAIN_RUN[:2]
    attention_row(lidc.arch_id, B, S, lidc.n_heads, lidc.n_kv_heads, lidc.hd, None,
                  "training layer (phase 14)", dtype_name="float32", phase14=True)
    bwd_row(f"{lidc.arch_id} (phase 14)", B, S, lidc.n_heads, lidc.n_kv_heads, lidc.hd,
            dtype_name="float32", phase14=True)
    for r in rows:
        print_row(r)
    return rows


def print_row(r):
    chain = (f", the chain it replaced {r['chain_ms']:.4f} / "
             f"{r['chain_ms_read_flush']:.4f} ms" if "chain_ms" in r else "")
    if "products_ms" in r:
        chain = (f", the two f32 products after it {r['products_ms']:.4f} / "
                 f"{r['products_ms_read_flush']:.4f} ms")
    step = r.get("per") or ("training step" if "training" in r["shape"] else "decode step")
    print(f"  {r['name']}: {r['ms']:.4f} ms, {r['ms_read_flush']:.4f} ms under a read "
          f"flush (bound {r['bound_ms']:.5f} ms by {r['bound_by']}, plain "
          f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms{chain}, "
          f"{r['launches']} launches, served {r['served_us_per_step']} us per {step}) "
          f"at {r['shape']}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke needs one GPU", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import bundle_for, param_count

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}; "
          f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    try:
        with Phase("phase 1: build"):
            t0 = time.perf_counter()
            so, log = _build.build()
            print(f"  built {so.name} in {time.perf_counter() - t0:.1f} s")
            for line in ptxas_summary(log):
                print(f"  {line}")

        with Phase("phase 2: kernels vs plain versions"):
            check_kernels(torch, dev)

        with Phase(f"phase 3: serve {SERVE_ARCH}"):
            cfg = get_config(SERVE_ARCH)
            t0 = time.perf_counter()
            params = bundle_for(cfg).init(cfg, 0, device=dev)
            torch.cuda.synchronize()
            print(f"  {param_count(cfg) / 1e9:.3f} B params, {cfg.n_layers} layers, "
                  f"d_model {cfg.d_model}, init {time.perf_counter() - t0:.1f} s")
            torch.cuda.reset_peak_memory_stats()
            launches, prompt_lengths, served = serve(torch, np, dev, cfg, params)
            print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        with Phase("phase 4: teacher-forced logits, kernel path vs plain path"):
            teacher_forced(torch, np, cfg, params)
            del params
            torch.cuda.empty_cache()

        with Phase(f"phase 5: serve {HYBRID_RUN[0]} (hybrid) through the serve steps"):
            hybrid = serve_hybrid(torch, np, dev)
            torch.cuda.empty_cache()

        with Phase(f"phase 6: serve {MOE_RUN[0]} (MoE) through the serve steps"):
            moe = serve_moe(torch, np, dev)
            torch.cuda.empty_cache()

        with Phase("phase 7: kernel times at serving shapes"):
            rows = kernel_table(torch, dev, {"launches": launches, "served": served},
                                prompt_lengths, hybrid, moe)

        with Phase(f"phase 8: train {TRAIN_RUN[0]} through run_training"):
            trained = train(torch, np, dev)
            for r in rows:
                if r["name"] == "flash_attention_bwd" and r["shape"].startswith(TRAIN_RUN[0]):
                    r["launches"] = trained["launches"]["flash_attention_bwd"]
                    r["served_us_per_step"] = trained["served"]["flash_attention_bwd"]
                    print_row(r)

        with Phase("phase 9: the executors on the card"):
            execd = executors(torch, np, dev)
            for r in rows:
                if r["shape"].startswith(f"{TRAIN_RUN[0]} ") and r["name"] in execd:
                    r["phase9"] = execd[r["name"]]

        with Phase(f"phase 10: train {MOE_TRAIN_RUN[0]} ({MOE_TRAIN_RUN[1]} layers) "
                   f"through run_training"):
            moe_trained = train_moe(torch, np, dev)
            for r in rows:
                if r["name"] == "moe_router_bwd":
                    r["launches"] = moe_trained["launches"]["moe_router_bwd"]
                    r["served_us_per_step"] = moe_trained["served"]["moe_router_bwd"]
                    r["products_us_per_step"] = moe_trained["products_us"]
                    print_row(r)

        with Phase(f"phase 11: train {HYBRID_TRAIN_RUN[0]} through run_training"):
            hybrid_trained = train_hybrid(torch, np, dev)
            for r in rows:
                if "(phase 11)" in r["shape"]:
                    r["launches"] = hybrid_trained["launches"][r["name"]]
                    r["served_us_per_step"] = hybrid_trained["served"][r["name"]]
                    print_row(r)

        with Phase(f"phase 12: serve and train {XLSTM_SERVE[0]} (ssm)"):
            serve_and_train_xlstm(torch, np, dev)

        with Phase(f"phase 13: serve and train {SEAMLESS_SERVE[0]} (encdec)"):
            seamless = serve_and_train_seamless(torch, np, dev)
            for r in rows:
                if "phase13" in r:
                    use = seamless[r["phase13"]]
                    r["launches"] = use["launches"][r["name"]]
                    r["served_us_per_step"] = use["served"][r["name"]]
                    print_row(r)

        with Phase("phase 14: train lidc-100m in f32 through run_training"):
            lidc = train_lidc_100m(torch, np, dev)
            for r in rows:
                if r.get("phase14"):
                    r["launches"] = lidc["launches"][r["name"]]
                    r["served_us_per_step"] = lidc["served"][r["name"]]
                    print_row(r)

        with Phase("phase 15: lidc-100m trained on a directory lake, killed and resumed in a "
                   "new process"):
            print(f"  on {card_line()}")
            lake15 = lake_across_processes(torch, np, dev)

        with Phase("phase 16: expert-parallel MoE, GPipe and the compressed step on two ranks"):
            ranks16 = collectives(torch)
        for r in rows:      # launches on phases 15 and 16's paths, beside each row's own
            if r.get("phase14"):
                r["phase15_launches"] = lake15[r["name"]]
                r["phase16_launches_per_rank"] = ranks16[0]["pp"].get(r["name"], 0)
            if r["name"] in ("moe_router", "moe_router_bwd") and "decode" not in r["shape"]:
                r["phase16_launches_per_rank"] = ranks16[0]["ep"].get(r["name"], 0)

        with Phase(f"phase 17: serve {MISTRAL_RUN[0]} at full width, {MISTRAL_RUN[1]} layers "
                   f"(GQA group 12)"):
            mistral = serve_mistral(torch, np, dev)
            torch.cuda.empty_cache()
            for r in rows:
                if r.pop("phase17", False):
                    r["launches"] = mistral["decode"]["flash_decode"]
                    r["served_us_per_step"] = mistral["served"]["flash_decode"]
                    print_row(r)

        with Phase("phase 18: named jobs through the port's own LIDC overlay"):
            print(f"  on {card_line()}")
            overlay = overlay_on_card(torch, np, dev)
            for r in rows:
                if r["shape"].startswith(f"{TRAIN_RUN[0]} ") and r["name"] in (
                        "flash_attention", "flash_attention_bwd", "flash_decode"):
                    r["phase18"] = {job: n[r["name"]] for job, n in overlay.items()
                                    if r["name"] in n}

        with Phase("phase 19: named sessions and named KV across a cluster failure"):
            print(f"  on {card_line()}")
            sessions = named_sessions_on_card(torch, np, dev)
            for r in rows:
                if r["shape"].startswith(f"{SESSION_KV_RUN[0]} ") and r["name"] in sessions[
                        "session_a"]:
                    r["phase19"] = {run_name: n[r["name"]] for run_name, n in sessions.items()}
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
