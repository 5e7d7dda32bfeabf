#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` with
nvcc, holds each against its plain PyTorch version at the shapes its
path gives it (and times it beside its bound and a library yardstick),
then drives the port's two paths on Llama-3.2-1B at full width and
depth with seeded random weights.

Serving: packed Llama-3.2-1B through the continuous-batching engine: the
one-shot 80% block prune of the JAX launcher (gate and up masks differ,
so the split fused-GLU kernel runs), then a short run whose up weight
takes gate's mask (the joint kernel). The same 12 requests also run
through the engine's other KV paths, in alternating order beside the
phased paged run: the contiguous (B, max_len) cache, mixed
decode+prefill batching (no stalled decode step), and, on 12 requests
sharing a 100-token system prompt after one warm request, the radix-tree
prefix cache against the same prompts with the cache off (12 hits, 12
copy-on-write copies, 1200 prompt tokens skipped); ``serve_loop``, the
greedy oracle, decodes 4 prompts of 64 tokens. Each serving run resets
the kernel launch counters just before and reads them just after, and
fails unless every kernel of its path launched (and, on the contiguous
cache, paged decode never did). On the model's first two layers in f32
the phased paged, contiguous, mixed and prefix-cached engines and
``serve_loop`` must give equal greedy streams (a divergence only at a
near-tie, see ``phase_parity``). The packed output is checked against
a pruned-dense run of the same weights (plain torch.matmul MLP): at each
of the 16 layers on the dense run's hidden states, end to end through
the engine on the model's first two layers, and in next-token logits at
full depth (see ``phase_e2e``). A profiled window of decode slabs shows
where a step's time goes.

Serving behind traffic, through the asyncio front door
(``serving/frontend.py``): the launcher's ``--frontdoor --sla --preempt``
trace at full depth, 8 batch requests filling every lane and 6
interactive arrivals that preempt batch lanes (their KV goes to host
memory and comes back at the saved frontier, no token prefilled twice),
against the same trace FIFO without preemption (``serve_frontdoor``:
TTFT and e2e per class). Then the chaos plans on the first two layers
in f32 (``serve_chaos``): a NaN lane, a host-side crash under the
watchdog, device loss, a corrupted offload record and a stalled step;
each must cost only its own request, or nothing after recovery, with
the other streams equal to the fault-free run's (a divergence only at a
near-tie); and the host crash once more at full depth in bf16, with the
recovery latency and the bytes salvaged.

Artifacts and hot-swap (``serving/artifact.py``, ``serving/hotswap.py``):
the packed split and joint models are sealed at full depth and loaded
twice with their canaries replayed under the exact gates (a seal and a
replay on one card agree bitwise); each of the ten artifact corruptions
on a two-layer full-width artifact is offered to a serving engine's
``swap_weights`` and must raise its typed error without a flip
(``artifact``, ``artifact_faults``). Then ``serve_swap``: the split
model serves the 12 prompts and swaps to the sealed joint model after
step 2 while 4 more requests arrive; streams admitted before the flip
equal a run without the swap bitwise, the later ones a fresh engine on
the new weights; the split GLU runs only for old lanes and the joint GLU
only for new ones; the old weights' memory is freed when their last lane
retires; the same swap behind the asyncio front door; a NaN in a new
lane inside the window rolls the swap back.

Tensor-parallel serving (``serve_tp``, after the swap): Llama-3.2-1B
at full width and depth over a model axis of 2 (``dist=``), two spawned
rank processes that each load the sealed split artifact and keep their
shard (``export.shard_params``), over NCCL with a card each or, on one
card, over gloo sharing it; the 12 requests through the TP engine,
phased and mixed, the 4 oracle prompts through ``serve_loop.generate``
and a short run of the joint artifact: on every rank, the streams equal
the single-device runs' (a first divergence only at a near-tie), the
block tables and page accounting equal theirs (a digest), the full-depth
logits within 2**-5 of their magnitude, every kernel of the path
launched, each rank holding about half the weight and KV bytes. In the
same ranks, ``serving/step.py::make_prefill_step`` with ``dist=`` on 8
prompts of 128 tokens over the shard-local packed params: sequence
parallelism (on by default, as in the reference) splits the stream
along S, the ranks reduce-scatter, and the gathered last-token logits
hold to the same bound against one device's ``make_prefill_step`` with
the greedy tokens equal but at near-ties. Then the kernels at a rank's
local shapes (``tp_kernel`` lines).

Training: 12 steps of the BLaST trainer (``train_loop.train``: masked
dense with in-step prune-and-grow, f32 params, bf16 compute) on 8 x 128
synthetic tokens, checked for a falling finite loss, exact per-column
keep counts after every refresh and exactly-zero pruned blocks in the
params and both Adam moments; no kernel launches there. Then the trained
masks are packed layer by layer and the fine-tuning gradient through
``make_bspmm_trainable`` (forward ``bspmm``, dX ``bspmm_t``) is held
against the trainer's own masked-dense STE gradient at all 16 layers.
The trained state is checkpointed at full depth (``train_ckpt``: a
blocking and an async save, verify, a bitwise restore), and the chaos
child (``training/faults.py``) at two layers is SIGKILLed, resumed, and
resumed again past a corrupted newest checkpoint; each must end where
an uninterrupted child ends (``train_chaos``). These child processes,
compared by their states and never by their time, run side by side.

The sharded train step (``train_tp``, after the chaos children, beside
which its ranks start and warm up on a small model): two spawned ranks
(NCCL with a card each, gloo sharing card 0 with one) run one process
group and two meshes over it. (a) A model axis of 2, sequence-parallel
(the default, as the reference's launcher trains): full-width,
full-depth Llama-3.2-1B trained through ``train_loop.train(dist=)``
exactly as ``train`` trains it on one device, for that run's first five
steps (its refreshes at steps 0 and 4): the losses and gradient norms
within a bf16 tolerance of the one-device run's, so is every layer's
gradient history (AdamW's v summed over the layer), the gathered masks
after both refreshes equal to its masks but for blocks that were
near-ties in its own block scores, and every step reduce-scatters.
Then distillation on the same axis (the paper's compression setting):
two steps with KD weight 0.5 and temperature 2 of the seeded init pruned
once to 0.5, its teacher that init dense and sharded like it (its
forward in the step, sequence-parallel too), against two one-device KD
steps from the same state that the script runs once the ranks have
exited, under the same tolerances. (b) A data axis of 2: two steps (3 and 4, the second a
refresh and distilled from the 4-layer dense init) of the deferred step
(``training/deferred.py``) with two microbatches and int8 error-feedback
compression on two whole 4-layer replicas: each leaf's compressed mean
within half a quantization step of the f32 mean over the same ranks,
the new params and masks those of the one-device refresh and AdamW
update applied to that compressed mean, each step's loss within the
bf16 tolerance of the one-device loss on the whole batch (with the KD
term on the second). The line prints the collectives per step by kind
and their bytes, each rank's bytes and the phase's seconds.

Observability (``repro_torch/obs``): ``obs_serve`` serves the 12
requests at full depth in three rounds, each an untraced and a traced
engine stepped in alternation (the host's speed drifts by tens of
percent over seconds, and alternation moves both alike), and holds the
streams and the count of synchronizing CUDA calls equal on and off, no
span constructed when off, the spans' sums equal to the engine's
``decode_s``/``prefill_s``, and the median over rounds of the traced
engine's tok/s over the untraced one's at 0.9 or more (it writes the
Chrome trace under ``build/obs``);
``obs_frontdoor`` scrapes the front door's ``/metrics`` endpoint every
second through the SLA trace (every scrape parses, no counter falls, the
last equals the registry); ``obs_postmortems`` checks the flight
recorder's dumps (reason, file, the victims' uids in the frozen records)
of every chaos plan, the swap rollback and a training rewind (a chaos
child); ``obs_train`` holds the ``train.step`` spans against the train
phase's step time and each step's CUDA event pair (a span may not end
before the step's device work), also over 12 more steps at the loop's
default ``log_every`` of 10, and holds two chaos children that train 4
steps, one untraced and one traced, to bitwise-equal final states.

The MoE family (``serve_moe``, after the dense ``--arch`` models):
deepseek-moe-16b (8 of its 28 layers) and qwen3-moe-235b-a22b (2 of 94)
at full width, packed at s = 0.8 through ``launch.serve.prune_and_pack``
and served through ``launch.serve._serve`` (8 prompts of 64 tokens x 32
new), phased, mixed and phased again: every MoE layer of every model
call launches the expert-batched fused GLU and ``bspmm`` once for all
its experts (once more for deepseek's shared experts), the repeated
phased streams are bitwise equal, and the layer adds no synchronizing
CUDA call (the same traffic with the MLP stubbed out makes as many).
Then the expert-batched kernel lines of one layer at decode C = 1 and at
a 128-token call's capacity, paged decode at qwen3-moe's G = 16 beside G
= 8, and the packed model against its pruned-dense export on two layers.

Expert parallelism (``serve_ep``): the two packed MoE models served on a
model axis of 2 (``dist=``: each rank computes E/2 experts, attention
tensor-parallel, router and shared experts whole) by two spawned ranks
that share the card over gloo, through ``launch.serve._serve`` with the
same traffic, phased and mixed, beside ``serve_ssm`` and
``serve_audio_vlm``: streams equal the single-device runs' (but for
near-ties), call for call (the MoE layer calls by tokens and capacity
equal), the expert batch launched once a layer call at E/2, 2L + 1
all-reduces a model call, half the expert bytes a rank; then the kernel
lines at a rank's E/2 experts. A ``timing`` line before ``kernels``
gives each phase group's end and length and the script's total.

The recurrent families (``serve_ssm``, after the MoE models):
rwkv6-3b (``ssm``: the chunked linear scan, its channel-mix through
``bspmm`` at 128 x 16 and 16 x 128 blocks) and zamba2-1.2b (``hybrid``:
Mamba2 layers and one shared attention + GLU block, the GLU an unstacked
2-D pack through the split fused GLU and ``bspmm``), each whole at full
width and depth through ``launch.serve.main`` and ``serve_loop.generate``
(8 prompts of 64 tokens x 32 new, token-by-token prefill into the
per-lane recurrent state); then, on a two-layer cut, the kernel lines of
layer 0, the chunked forward against 64 decode steps in f32
(``ssm_scan``) and the packed export against the pruned-dense one
(``ssm_parity``).

Prints JSON lines; the line before the last is a ``kernels`` summary and
the last is ``{"ok": true, "device": {...}}``. Any failed phase raises
and the script exits non-zero without that line. Needs one CUDA card.
"""
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
DEVICE = "cuda"
N_REQUESTS, NEW_TOKENS = 12, 64
ENGINE = dict(max_batch=8, max_len=512, page_size=16, prefill_chunk=16,
              slab_k=8)
# shared-system-prompt traffic: a 100-token prefix (not page-aligned, so
# each hit copies its boundary page), suffixes of 16-48 tokens
PREFIX_LEN, PREFIX_TOKENS = 100, 32
LOOP_PROMPTS, LOOP_LEN, LOOP_TOKENS = 4, 64, 32
PARITY_DEPTH, PARITY_TOKENS, NEAR_TIE = 2, 16, 1e-4
# the front-door SLA trace (launch/serve.py --frontdoor --sla --preempt),
# sized so that every lane is busy when the interactive tier arrives
FD_BATCH_PROMPT, FD_BATCH_TOKENS = 128, 256
FD_INTER, FD_INTER_PROMPT, FD_INTER_TOKENS = 6, 64, 16
FD_FIRST_S, FD_GAP_S, FD_DEADLINE_S = 0.5, 0.25, 0.5
# chaos: the watchdog's hung-step deadline, many times the slowest step
# it guards (2 layers: tens of ms; full depth: a 1024-token prefill)
CHAOS_REQUESTS, CHAOS_TOKENS = 12, 32
CHAOS_WATCHDOG_S, CHAOS_WATCHDOG_FULL_S = 5.0, 30.0
# sealed artifacts (under the gitignored build/, deleted after use), the
# tokens of the stream that runs while every artifact fault is offered to
# the engine, and the hot-swap: the swap after step 2, 4 requests after
# it; the training chaos child's depth and steps (checkpoints every 4,
# the kill at 11, refreshes every 5)
ART_DIR = os.path.join(ROOT, "build", "chip_artifacts")
FAULT_TOKENS, SWAP_AFTER_STEP, SWAP_POST = 32, 2, 4
CHAOS_LAYERS, CHAOS_STEPS, CHAOS_KILL = 2, 12, 11
# full-width chaos children run beside the A -> A2 -> A3 chain at once
# (three at a time with the chain's fit the card's 80 GB; four did not)
CHAOS_SIDE = 2
# train_ckpt runs beside the chain's first children only where the card's
# free bytes, less what the script holds (the restore makes a second copy
# of the state), leave CKPT_BESIDE_FREE for a chain child (≈14-20 GB),
# the rewind child and train_tp's warming ranks; else it runs first
CKPT_BESIDE_FREE = 36 << 30

# datasheet figures (SXM parts, dense rates): bytes/s of device memory and
# operations/s by input type (f32 outside the tensor cores, as the kernels
# compute)
CARDS = {"H100": {"bytes_s": 3.35e12, "bf16": 989e12, "f32": 67e12},
         "H200": {"bytes_s": 4.8e12, "bf16": 989e12, "f32": 67e12}}

REPLACES = {
    "bspmm": ("src/repro_torch/csrc/bspmm.cu",
              "src/repro/kernels/bspmm.py:37"),
    "fused_glu_split": ("src/repro_torch/csrc/bspmm.cu",
                        "src/repro/kernels/bspmm.py:95"),
    "fused_glu_joint": ("src/repro_torch/csrc/bspmm.cu",
                        "src/repro/kernels/bspmm.py:124"),
    "paged_flash_decode": ("src/repro_torch/csrc/paged_attention.cu",
                           "src/repro/kernels/paged_attention.py:53"),
    "bspmm_t": ("src/repro_torch/csrc/bspmm_t.cu",
                "src/repro/kernels/bspmm_t.py:46"),
}
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEP_SIZE = 12, 128, 8, 4
# observability: postmortems and the Chrome trace under the gitignored
# build/; the serving runs with tracing off and on, interleaved; the
# front door's /metrics scrape period; the traced/untraced tok/s floor
# (a gross-fault alarm, not a benchmark); the train.step span median's
# tolerance against the phase's step time; the on/off training pair's
# steps and the rewind child's NaN steps (a rewind at 7 to step 4); the
# steps of the traced run at the loop's default log_every
OBS_DIR = os.path.join(ROOT, "build", "obs")
OBS_ROUNDS, OBS_SCRAPE_S, OBS_TOK_FLOOR, OBS_STEP_TOL = 3, 1.0, 0.9, 0.10
OBS_PAIR_STEPS, OBS_REWIND_NAN, OBS_REWIND_STEPS = 4, [5, 6, 7], 8
OBS_UNLOGGED_STEPS = 12
# the four dense --arch configurations, packed at s = 0.8: qwen2-7b whole
# through the launcher's main() (depth None), the others at full width
# with their depth cut (f32 init of gemma2-27b at full depth is ~109 GB);
# the launcher's 8 prompts of 64 tokens x 32 new; kernel lines at M = 8
# rows and B = 8 lanes over R = 16 pages; parity prompts of 64-128 tokens
ARCH_RUNS = {"qwen2-7b": None, "stablelm-3b": 4, "stablelm-12b": 4,
             "gemma2-27b": 4}
ARCH_SPARSITY, ARCH_BATCH, ARCH_PROMPT, ARCH_TOKENS = 0.8, 8, 64, 32
ARCH_M, ARCH_DECODE_B, ARCH_DECODE_R, ARCH_PARITY_PROMPTS = 8, 8, 16, 4
# the two MoE --arch configurations at full width, packed at s = 0.8, each
# depth cut so that one card holds its f32 init beside the export's masked
# f32 copies (deepseek at its 28 layers is ~67.6 GB of f32 alone; qwen3-moe
# at 3 layers peaks near 78 GB); the launcher's traffic of ARCH_*; the
# kernel lines at every capacity C the served runs used
MOE_RUNS = {"deepseek-moe-16b": 8, "qwen3-moe-235b-a22b": 2}
SYNC_WARNING = "called a synchronizing CUDA operation"
# the recurrent --arch families (rwkv6 ssm, zamba2 hybrid), whole (full
# width and depth) through launch.serve.main with the launcher's traffic
# of ARCH_*; the scan check's lanes x tokens (one chunk of 64) in f32;
# its tolerance and the packed-vs-dense logits' (1e-3 of the logits'
# magnitude: two layers, f32 sums in other orders) beside the MLP's
# (ulp_tol's f32 1e-4)
SSM_RUNS = ("rwkv6-3b", "zamba2-1.2b")
SSM_SCAN_B, SSM_SCAN_S, SSM_LOGIT_TOL = 2, 64, 1e-3
# the last two --arch families, whole: whisper-large-v3 (audio) through
# prune_and_pack + serve_loop.generate(frames=) (the launcher makes no
# frames) on ARCH_BATCH lanes of AUDIO_FRAMES frames (its published
# max_source_positions; seeded normals x 0.02), and internvl2-2b (vlm)
# through launch.serve.main (text prompts through the engine, as the
# reference serves it), both with the launcher's traffic of ARCH_*; the
# two-layer parities' lanes and decoder tokens (the VLM adds its 256
# patches in front)
AUDIO_VLM_RUNS = ("whisper-large-v3", "internvl2-2b")
AUDIO_FRAMES, AV_PARITY_B, AV_PARITY_TOKENS = 1500, 4, 64
# tensor-parallel serving (serve_tp): the model axis, the rank processes'
# gloo/NCCL store under the gitignored build/, their time limit; a rank's
# weight bytes may be at most TP_BYTES_FRACTION of the single-device
# packed bytes plus the leaves every rank holds whole; the streams'
# near-tie margin is TP_NEAR_TIE times the full-depth logits tolerance
# (2**-5 of their magnitude, phase_e2e's), since two bf16 orders of the
# same sums differ by about that
TP_SIZE, TP_TIMEOUT_S, TP_BYTES_FRACTION, TP_NEAR_TIE = 2, 900, 0.55, 2.0
TP_DIR = os.path.join(ROOT, "build", "chip_tp")
# expert-parallel serving (serve_ep): serve_moe's two packed models on a
# model axis of EP_SIZE ranks sharing card 0 over gloo, their store under
# the gitignored build/; the bytes, near-tie and time limits of serve_tp
EP_SIZE = 2
EP_DIR = os.path.join(ROOT, "build", "chip_ep")
EP_WEIGHTS = os.path.join(ROOT, "build", "chip_ep_weights")
# serve_tp_av: whisper-large-v3 and internvl2-2b whole, served at a model
# axis of TP_AV_SIZE ranks sharing card 0 over gloo (their store and the
# trees serve_audio_vlm hands them under the gitignored build/), on short
# traffic: ARCH_BATCH lanes of TP_AV_PROMPT prompt tokens and
# TP_AV_TOKENS new ones (whisper over serve_audio_vlm's AUDIO_FRAMES
# frames), since a gloo collective on one card takes ~4.5 ms and whisper
# makes ~130 a token step; the VLM's engine as TP_AV_ENGINE says
TP_AV_SIZE, TP_AV_PROMPT, TP_AV_TOKENS = 2, 8, 8
TP_AV_ENGINE = dict(max_batch=ARCH_BATCH, max_len=TP_AV_PROMPT + TP_AV_TOKENS,
                    page_size=16, prefill_chunk=8, slab_k=8)
TP_AV_DIR = os.path.join(ROOT, "build", "chip_tp_av")
TP_AV_WEIGHTS = os.path.join(ROOT, "build", "chip_tp_av_weights")
# serve_ssm_tp: rwkv6-3b and zamba2-1.2b whole, served at a model axis of
# SSM_TP_SIZE ranks sharing card 0 over gloo (their store and the trees
# serve_ssm hands them under the gitignored build/), through
# serve_loop.generate on serve_tp_av's short traffic (ARCH_BATCH lanes of
# TP_AV_PROMPT prompt tokens, TP_AV_TOKENS new)
SSM_TP_SIZE = 2
# serve_ssm_tp's passes a model, by activation dtype: "served" is served
# and its streams held against one device's in that dtype; "logits" is a
# bf16 pass held by its launches, its all-reduces and its teacher-forced
# last logits. The random weights make both models' bf16 streams chaotic
# at full depth (one device's bf16 and f32 last logits differ by 0.92 of
# their magnitude for rwkv6-3b and 0.26 for zamba2-1.2b on an H100, and
# zamba's bf16 streams at model 2 part from one device's at a top-2
# margin of 0.39, above the 0.27 near-tie bound), so both serve f32
# activations on the bf16 weights. f32 activations take the kernels' FMA
# loops, bf16 their mma path
SSM_TP_PASSES = {a: {"served": "float32", "logits": "bfloat16"}
                 for a in ("rwkv6-3b", "zamba2-1.2b")}
SSM_TP_DIR = os.path.join(ROOT, "build", "chip_ssm_tp")
SSM_TP_WEIGHTS = os.path.join(ROOT, "build", "chip_ssm_tp_weights")
# serve_dp: Llama-3.2-1B whole at (data, model) = DP_SHAPE, 4 ranks sharing
# card 0 over gloo, loading the sealed split artifact beside serve_swap;
# the engine serves serve_tp's 12 requests with DP_TOKENS new tokens (64
# in serve_tp) and serve_loop.generate its 4 oracle prompts cut to
# DP_LOOP_LEN tokens with DP_LOOP_TOKENS new (64 and 32 there). Half the
# traffic is the cut the time budget forces: on an H100 the ranks alone
# take 45.8 / 70.7 / 102.9 s from their start to the join at 16 / 32 /
# 64 new tokens, and the one-device oracle after the join 11.0 / 20.9 /
# 31.8 s, against ~100 s beside serve_swap and serve_tp (a gloo collective
# on one card takes ~4.5 ms, and a Llama step makes ~50)
DP_SHAPE, DP_TOKENS, DP_LOOP_LEN, DP_LOOP_TOKENS = (2, 2), 32, 32, 16
DP_DIR = os.path.join(ROOT, "build", "chip_dp")
# train_tp: (a) the first TRAIN_TP_STEPS steps of the train phase's run
# (its refreshes at 0 and TRAIN_STEP_SIZE) at a model axis of 2; (b)
# TRAIN_DP_STEPS deferred int8 steps from step TRAIN_DP_START (a
# learning rate above 0; the second a refresh) on TRAIN_DP_LAYERS-layer
# replicas over a data axis of 2. (a)'s losses and gradient norms hold to
# TRAIN_TP_TOL relative: the sharded run's readings against one device
# are 1.24e-3 and 8.0e-4 (bf16 sums in another order), and with
# copy_to_model planted as the identity 0.18 and 0.74 (PERF.md §6, PR
# 26). Each layer's gradient history (the square root of the sum of
# AdamW's v over the layer's part of a leaf) holds to TRAIN_TP_LAYER_TOL
# relative (readings 3.0e-3, planted fault 1.5): it catches a fault in a
# few leaves that the loss and the global norm cannot show. A mask block may differ from the one-device run's where
# its one-device score lies within TRAIN_TP_TIE (relative) of its
# column's selection boundary. (b)'s new params equal the one-device
# refresh and AdamW update applied to the step's compressed mean within
# TRAIN_DP_UPDATE_TOL of the learning rate.
TRAIN_TP_STEPS, TRAIN_DP_LAYERS = 5, 4
TRAIN_DP_START, TRAIN_DP_STEPS = 3, 2
TRAIN_TP_TOL, TRAIN_TP_LAYER_TOL = 2.0 ** -8, 2.0 ** -6
TRAIN_TP_TIE, TRAIN_DP_UPDATE_TOL = 2.0 ** -5, 1e-3
TRAIN_TP_DIR = os.path.join(ROOT, "build", "chip_train_tp")
# distillation in train_tp (the paper's compression setting, §5.2): the
# student starts from the seeded init pruned once by magnitude to
# KD_SPARSITY (the dense_last layers kept), the teacher is that seeded
# init dense; KD_STEPS steps from step KD_START (no refresh at either) at
# KD weight KD_BETA and temperature KD_TEMPERATURE, sharded against one
# device under (a)'s tolerances; (b)'s second step adds the KD term
KD_SPARSITY, KD_START, KD_STEPS = 0.5, 5, 2
KD_BETA, KD_TEMPERATURE = 0.5, 2.0
# serve_tp's full-sequence prefill (make_prefill_step with dist=, so
# sequence-parallel): SP_PREFILL prompts of SP_PREFILL_LEN tokens
SP_PREFILL, SP_PREFILL_LEN = 8, 128


T0 = time.monotonic()


def emit(**obj):
    """One JSON line; a phase's line also carries ``t``, the seconds since
    the script started, which time the phases."""
    if "phase" in obj:
        obj["t"] = time.monotonic() - T0
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ------------------------------------------------------------------ timing
class Timer:
    """Median device time of one call, each rep after an L2 flush: on the
    served path every layer's weights arrive cold from device memory. The
    flush writes the 256 MB buffer FLUSHES times (~0.34 ms of device
    work), so the card is still busy while the host runs the wrapper and
    enqueues the kernel: the events then bracket the kernel, not the
    host (a single pass did not hide a slow host's wrapper time)."""

    FLUSHES = 4

    def __init__(self, torch, reps=25):
        self.torch, self.reps = torch, reps
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8,
                                 device=DEVICE)
        for _ in range(50):      # a busy card first: clocks up before the
            self.flush.zero_()   # first case is timed
        torch.cuda.synchronize()

    def flush_l2(self):
        for _ in range(self.FLUSHES):
            self.flush.zero_()

    def ms(self, fn):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(self.reps):
            self.flush_l2()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def profiled_ms(torch, timer, fn, name, reps=25):
    """The profiler's mean device duration of the kernels whose name
    holds ``name`` (``bsp::`` for the shared block-sparse loops,
    ``paged_decode`` for paged decode) in ``fn``, each call after the
    same L2 flush as ``Timer``; "not measured" when the profiler records
    none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            timer.flush_l2()
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and name in e.key]
    n = sum(e.count for e in evs)
    if not n:
        return "not measured"
    return sum(e.self_device_time_total for e in evs) / n / 1e3


def bound_ms(card, nbytes, ops, dtype_key):
    tb = nbytes / card["bytes_s"]
    to = ops / card[dtype_key]
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def ulp_tol(torch, ref, dtype):
    """Tolerance on max |kernel - plain|: f32 about 1e-4 of the output's
    magnitude (the two sum in different orders); bf16 two bf16 ulps of
    the output's magnitude (each side rounds its f32 result once, and
    the plain fused GLU also rounds gate and up before the activation)."""
    mag = float(ref.float().abs().max())
    if dtype == torch.float32:
        return 1e-4 * mag
    return 2.0 * 2.0 ** (math.floor(math.log2(max(mag, 1e-30))) - 7)


# ------------------------------------------------------------------ phases
def phase_env(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    from repro_torch.kernels import build
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    # plain f32 products must not run in TF32 for the f32 checks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    emit(phase="env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc,
         device=torch.cuda.get_device_name(0),
         python=sys.version.split()[0])
    name = torch.cuda.get_device_name(0)
    for key, card in CARDS.items():
        if key in name:
            return card
    raise SmokeFailure(f"no datasheet figures for {name!r}")


def phase_build():
    from repro_torch.kernels import build
    t0 = time.monotonic()
    paths = build.build_all()
    emit(phase="build", seconds=time.monotonic() - t0,
         libraries={k: os.path.relpath(str(v), ROOT)
                    for k, v in paths.items()})


def phase_model(torch, cfg):
    """Seeded f32 weights on the card, the launcher's one-shot prune at 0.8
    (``launch.serve.prune_and_pack``; dense_last not applied), then the
    packed (split), packed joint and pruned-dense serving params."""
    import repro_torch.launch.serve as launcher
    from repro_torch.models import registry
    from repro_torch.serving import export
    t0 = time.monotonic()
    params = registry.init_params(cfg, SEED, device=DEVICE)
    masks = launcher.one_shot_masks(cfg, params, 0.8)
    jmasks = dict(masks)
    jmasks["layers/mlp/w_up"] = masks["layers/mlp/w_gate"]
    pad = {}
    packed = launcher.prune_and_pack(cfg, params, 0.8, True, masks=masks,
                                     pad_report=pad)
    joint = launcher.prune_and_pack(cfg, params, 0.8, True, masks=jmasks,
                                    pad_report=pad)
    dense = launcher.prune_and_pack(cfg, params, 0.8, False, masks=masks)
    del params, masks, jmasks
    check(not pad, f"one-shot masks are unbalanced: {pad}")
    mlp, jmlp = packed["layers"]["mlp"], joint["layers"]["mlp"]
    check(not mlp["w_gate"].joint and jmlp["w_gate"].joint
          and jmlp["w_up"].joint, "joint marking is wrong")
    emit(phase="model", config=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         sparsity=0.8, seconds=time.monotonic() - t0,
         nnz={k: mlp[k].nnz for k in ("w_gate", "w_up", "w_down")},
         kb={k: mlp[k].kb for k in ("w_gate", "w_up", "w_down")},
         memory_packed=export.memory_report(cfg, packed),
         memory_dense=export.memory_report(cfg, dense),
         memory_packed_joint=export.memory_report(cfg, joint))
    return packed, joint, dense


def _record(torch, card, phase, name, dt, shape, got, want, t_k, t_p, t_l,
            nbytes, ops_, **extra):
    """Hold one kernel's result against its plain version's within
    ``ulp_tol`` and emit its line (times, bound, library time)."""
    err = float((got.float() - want.float()).abs().max())
    tol = ulp_tol(torch, want, dt)
    key = "bf16" if dt == torch.bfloat16 else "f32"
    b_ms, b_by = bound_ms(card, nbytes, ops_, key)
    emit(phase=phase, name=name, dtype=key, shape=shape, max_abs_err=err,
         tol=tol, ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
         bound_by=b_by, **extra)
    check(err <= tol and math.isfinite(err),
          f"{name} {key} {shape}: max abs err {err} > tol {tol}")
    return dict(max_abs_err=err, tol=tol, ms=t_k, plain_ms=t_p,
                library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
                shape=shape, dtype=key, **extra)


def phase_kernels(torch, card, packed, joint):
    """Each kernel against its plain version on the card, at the serving
    shapes: layer 0's real packed weights, M in {5, 8, 128} rows
    (decode lanes and a prefill chunk of 8 lanes x 16) and, in bf16, M in
    {16, 32, 64} (the mixed step's 8 lanes x W in {2, 4, 8}) for the MLP
    kernels, B=8 lanes and R in {1, 4, 16, 32} pages for decode, in bf16
    and f32; and bspmm at packed fine-tuning's M = 1024 rows on the gate
    shape X (1024, 2048) -> (1024, 8192) and the down shape. Each bspmm
    and fused-GLU line (split and joint) names the kernel and split it
    took (``plan``) and each paged line its CTAs per (lane, kv head)
    (``splits``); their bf16 lines also give the profiler's kernel
    duration beside the event time.
    Returns per-kernel summaries at the decode shape (M=8 bf16, R=16
    bf16: the largest read bucket of the served traffic)."""
    import torch.nn.functional as F
    from repro_torch.core.packing import PackedBCSC, unpack
    from repro_torch.kernels import bspmm as kb, ops, split_plan
    from repro_torch.kernels import paged_attention as pa
    timer = Timer(torch)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    n_sm = kb.n_sms(torch.cuda.current_device())
    summary = {}

    def cast(p, dt):
        return PackedBCSC(p.blocks.to(dt).contiguous(), p.idx, p.kb, p.joint)

    mlp0 = {k: v.layer(0) for k, v in packed["layers"]["mlp"].items()}
    jmlp0 = {k: v.layer(0) for k, v in joint["layers"]["mlp"].items()}
    dense_down = unpack(mlp0["w_down"])
    dense_gu = torch.cat([unpack(mlp0["w_gate"]),
                          unpack(mlp0["w_up"])], dim=1)
    dense_gu_j = torch.cat([unpack(jmlp0["w_gate"]),
                            unpack(jmlp0["w_up"])], dim=1)

    def record(*args, **extra):
        return _record(torch, card, "kernel", *args, **extra)

    for dt in (torch.bfloat16, torch.float32):
        es = 2 if dt == torch.bfloat16 else 4
        down = cast(mlp0["w_down"], dt)
        gate, up = cast(mlp0["w_gate"], dt), cast(mlp0["w_up"], dt)
        jgate, jup = cast(jmlp0["w_gate"], dt), cast(jmlp0["w_up"], dt)
        wd, wgu, wgu_j = (dense_down.to(dt), dense_gu.to(dt),
                          dense_gu_j.to(dt))
        # 16-64 rows: the mixed step's MLP (8 lanes x W in {2, 4, 8})
        # and short prefill chunks, on the 64x64x64 tile from 17 rows
        rows_m = ((5, 8, 16, 32, 64, 128) if dt == torch.bfloat16
                  else (5, 8, 128))
        for m in rows_m:
            h = torch.randn(m, down.kb * down.b_in, generator=gen,
                            device=DEVICE).to(dt)
            x = torch.randn(m, gate.kb * gate.b_in, generator=gen,
                            device=DEVICE).to(dt)
            n_dn = down.nb * down.b_out
            n_ff = gate.nb * gate.b_out
            blk = lambda p: p.blocks.numel() * es + p.idx.numel() * 4  # noqa
            rows = {
                "bspmm": (
                    lambda: kb.bspmm(h, down), lambda: ops.bspmm_plain(h, down),
                    lambda: torch.matmul(h, wd),
                    h.numel() * es + blk(down) + m * n_dn * es,
                    ops.flops_bspmm(m, down)),
                "fused_glu_split": (
                    lambda: kb.fused_glu(x, gate, up),
                    lambda: ops.fused_glu_plain(x, gate, up),
                    lambda: torch.matmul(x, wgu),
                    x.numel() * es + blk(gate) + blk(up) + m * n_ff * es,
                    ops.flops_bspmm(m, gate) + ops.flops_bspmm(m, up)),
                "fused_glu_joint": (
                    lambda: kb.fused_glu(x, jgate, jup),
                    lambda: ops.fused_glu_plain(x, jgate, jup),
                    lambda: torch.matmul(x, wgu_j),
                    x.numel() * es + jgate.blocks.numel() * es * 2
                    + jgate.idx.numel() * 4 + m * n_ff * es,
                    ops.flops_bspmm(m, jgate) * 2),
            }
            plans = {"bspmm": kb.launch_plan(h, down),
                     "fused_glu_split": kb.launch_plan(x, gate, up),
                     "fused_glu_joint": kb.launch_plan(x, jgate, jup)}
            for name, (k_fn, p_fn, l_fn, nbytes, ops_) in rows.items():
                extra = {}
                if name in plans:
                    extra["plan"] = plans[name].describe()
                    if dt == torch.bfloat16:
                        extra["profiler_ms"] = profiled_ms(torch, timer,
                                                           k_fn, "bsp::")
                res = record(name, dt, [m], k_fn(), p_fn(), timer.ms(k_fn),
                             timer.ms(p_fn), timer.ms(l_fn), nbytes, ops_,
                             **extra)
                if dt == torch.bfloat16 and m == 8:
                    summary[name] = res
        # packed fine-tuning's forward: M = 1024 rows (8 x 128 tokens)
        for shape, p in (("gate", gate), ("down", down)):
            m = 1024
            x = torch.randn(m, p.kb * p.b_in, generator=gen,
                            device=DEVICE).to(dt)
            wdense = unpack(p)
            k_fn = lambda: kb.bspmm(x, p)  # noqa: E731
            p_fn = lambda: ops.bspmm_plain(x, p)  # noqa: E731
            l_fn = lambda: torch.matmul(x, wdense)  # noqa: E731
            nbytes = (x.numel() * es + p.blocks.numel() * es
                      + p.idx.numel() * 4 + m * p.nb * p.b_out * es)
            record("bspmm", dt, [m, shape], k_fn(), p_fn(), timer.ms(k_fn),
                   timer.ms(p_fn), timer.ms(l_fn), nbytes,
                   ops.flops_bspmm(m, p),
                   plan=kb.launch_plan(x, p).describe())
        # decode: B=8 lanes, 8 kv heads x 4 query heads of 64, pages of 16,
        # a pool of 256 pages per layer (the served engine's)
        b, kvh, g, hd, ps, n_pages = 8, 8, 4, 64, 16, 256
        pk_ = torch.randn(n_pages, ps, kvh, hd, generator=gen,
                          device=DEVICE).to(dt)
        pv_ = torch.randn(n_pages, ps, kvh, hd, generator=gen,
                          device=DEVICE).to(dt)
        table = torch.randperm(n_pages, generator=gen, device=DEVICE)[
            :b * 32].reshape(b, 32).to(torch.int32)
        for r in (1, 4, 16, 32):
            q4 = torch.randn(b, kvh, g, hd, generator=gen,
                             device=DEVICE).to(dt)
            bt = table[:, :r]                       # strided, as served
            lens = torch.randint(1, r * ps + 1, (b,), generator=gen,
                                 device=DEVICE)
            slots = torch.arange(r * ps, device=DEVICE)[None]
            bias = torch.where(slots < lens[:, None], 0.0,
                               pa.NEG_INF).float().contiguous()
            valid = int(lens.sum())
            k_fn = lambda: pa.paged_flash_decode(  # noqa: E731
                q4, pk_, pv_, bt, bias, scale=0.125)
            p_fn = lambda: pa.paged_flash_decode_plain(  # noqa: E731
                q4, pk_, pv_, bt, bias, scale=0.125)
            # yardstick: SDPA over the pre-gathered pages (gather untimed)
            gk = pk_[bt.long()].reshape(b, r * ps, kvh, hd).transpose(1, 2)
            gv = pv_[bt.long()].reshape(b, r * ps, kvh, hd).transpose(1, 2)
            qs = q4.reshape(b, kvh * g, 1, hd)
            am = (slots < lens[:, None])[:, None, None, :]
            l_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qs, gk, gv, attn_mask=am, scale=0.125, enable_gqa=True)
            nbytes = (q4.numel() * es + valid * kvh * hd * es * 2
                      + bt.numel() * 4 + bias.numel() * 4 + q4.numel() * 4)
            ops_ = 4 * valid * kvh * g * hd
            extra = {"splits": split_plan.decode_splits(b, kvh, r, n_sm)}
            if dt == torch.bfloat16:
                extra["profiler_ms"] = profiled_ms(torch, timer, k_fn,
                                                   "paged_decode")
            res = record("paged_flash_decode", dt, [b, r], k_fn(), p_fn(),
                         timer.ms(k_fn), timer.ms(p_fn), timer.ms(l_fn),
                         nbytes, ops_, **extra)
            if dt == torch.bfloat16 and r == 16:
                summary["paged_flash_decode"] = res
    return summary


def _counters():
    from repro_torch.kernels import bspmm as kb, bspmm_t as kt
    from repro_torch.kernels import paged_attention as pa
    return (kb.LAUNCHES, kt.LAUNCHES, pa.LAUNCHES)


def _reset_counts():
    for d in _counters():
        for k in d:
            d[k] = 0


def _read_counts():
    return {k: v for d in _counters() for k, v in d.items()}


def _serve(cfg, params, prompts, new_tokens, warm=(), **mode):
    """One engine run of ``prompts``; ``warm`` requests run to the end
    first and their stats are dropped (the prefix cache keeps what they
    inserted)."""
    from repro_torch.serving.engine import Engine
    eng = Engine(cfg, params, device=DEVICE, **ENGINE, **mode)
    for p in warm:
        eng.submit(p, new_tokens)
    if warm:
        eng.run()
        eng.reset_stats()
    uids = [eng.submit(p, new_tokens) for p in prompts]
    t0 = time.monotonic()
    res = eng.run()
    wall = time.monotonic() - t0
    return eng, [res[u] for u in uids], wall


def _kv_slab_bytes(cfg, batch, max_len):
    """Bytes of a contiguous bf16 K+V cache of ``batch`` rows."""
    from repro_torch.models import attention
    _, kv = attention.eff_heads(cfg)
    return 2 * cfg.num_layers * batch * max_len * kv * cfg.head_dim * 2


def phase_serve(torch, cfg, name, params, prompts, new_tokens, must_launch,
                must_not, warm=(), **mode):
    """One serving run, launch counters reset just before and read just
    after. Returns (results, counts, stats)."""
    _reset_counts()
    eng, results, wall = _serve(cfg, params, prompts, new_tokens, warm,
                                **mode)
    counts = _read_counts()
    st = eng.stats
    done = sum(r.ok and r.generated.size == new_tokens for r in results)
    extra = {}
    if not eng.paged:
        extra["kv_slab_bytes"] = _kv_slab_bytes(cfg, ENGINE["max_batch"],
                                                ENGINE["max_len"])
        check(st["peak_kv_bytes"] == extra["kv_slab_bytes"],
              f"{name}: peak KV {st['peak_kv_bytes']} is not the slab's")
    if eng.pcache is not None:
        extra.update({k: st[k] for k in (
            "prefix_hits", "prefix_misses", "prefill_tokens_skipped",
            "cow_copies", "cache_evicted_pages", "prefix_hit_rate",
            "peak_kv_bytes_referenced")})
    emit(phase="serve", run=name, mode=mode, submitted=len(prompts),
         completed=done, completed_equals_submitted=done == len(prompts),
         tok_per_s=st["tok_per_s"], ttft_p50_s=st["ttft_p50_s"],
         ttft_p95_s=st["ttft_p95_s"], decode_slabs=st["decode_slabs"],
         prefill_chunks=st["prefill_chunks"], mixed_steps=st["mixed_steps"],
         stalled_decode_steps=st["stalled_decode_steps"],
         generated_tokens=st["generated_tokens"],
         peak_kv_bytes=st["peak_kv_bytes"],
         kv_bytes_contiguous_equiv=st["kv_bytes_contiguous_equiv"],
         pages_read=st["pages_read"],
         pages_read_dense_equiv=st["pages_read_dense_equiv"],
         wall_s=wall, launches=counts, **extra)
    check(done == len(prompts), f"{name}: {done}/{len(prompts)} completed")
    for r in results:
        g = r.generated
        check(bool(((g >= 0) & (g < cfg.vocab_size)).all()),
              f"{name}: token outside the vocabulary")
    for k in must_launch:
        check(counts[k] > 0, f"{name}: kernel {k} never launched")
    for k in must_not:
        check(counts[k] == 0, f"{name}: kernel {k} launched unexpectedly")
    return results, counts, dict(st, lockstep_digest=eng.lockstep_digest)


def _brief(st):
    return {k: st[k] for k in ("tok_per_s", "ttft_p50_s", "ttft_p95_s",
                               "peak_kv_bytes")}


PAGED = ("bspmm", "fused_glu_split", "paged_flash_decode")


def phase_serve_modes(torch, cfg, packed, prompts, phased):
    """The served 12 requests through the contiguous cache and mixed
    batching, beside the phased paged run: phased (already run),
    contiguous, mixed, then mixed, contiguous, phased again (decode is
    host-bound, so the order alternates). Returns the launch counts and
    the first mixed run's (results, stats)."""
    runs = {"packed_split": [phased]}
    counts, mixed = [], None
    for name in ("serve_contiguous", "serve_mixed", "serve_mixed",
                 "serve_contiguous", "packed_split"):
        mode = {"serve_contiguous": dict(paged=False),
                "serve_mixed": dict(mixed=True),
                "packed_split": {}}[name]
        must = (("bspmm", "fused_glu_split") if name == "serve_contiguous"
                else PAGED)
        must_not = (("fused_glu_joint", "paged_flash_decode")
                    if name == "serve_contiguous" else ("fused_glu_joint",))
        res, c, st = phase_serve(torch, cfg, name, packed, prompts,
                                 NEW_TOKENS, must, must_not, **mode)
        if name == "serve_mixed" and mixed is None:
            mixed = (res, st)
        if name == "serve_mixed":
            check(st["stalled_decode_steps"] == 0,
                  f"mixed: {st['stalled_decode_steps']} stalled steps")
            check(st["mixed_steps"] > 0, "mixed: no fused call ran")
        runs.setdefault(name, []).append(_brief(st))
        counts.append(c)
    emit(phase="serve_modes", requests=len(prompts), new_tokens=NEW_TOKENS,
         order=["packed_split", "serve_contiguous", "serve_mixed",
                "serve_mixed", "serve_contiguous", "packed_split"],
         runs=runs, kv_slab_bytes=_kv_slab_bytes(cfg, ENGINE["max_batch"],
                                                 ENGINE["max_len"]))
    return counts, mixed


def _span_summary(records) -> dict:
    """{name: count, seconds summed and the median in ms} of a ring."""
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r.dur)
    return {k: {"count": len(v), "sum_s": sum(v),
                "p50_ms": statistics.median(v) * 1e3}
            for k, v in sorted(out.items())}


def _lockstep(cfg, params, prompts, tracer, made):
    """One ``obs_serve`` round: two engines, one untraced and one under
    ``tracer``, each given ``prompts``, driven by ``Engine.step`` in
    alternation (the untraced first at even steps, the traced first at
    odd) until both drain, so that the host's speed, which drifts by tens
    of percent over seconds, moves both alike. Per side: the results, the
    engine, and over its own steps the synchronizing CUDA calls, the
    ``Span``s constructed, the kernel launches, the wall and this
    thread's CPU seconds; the submissions' spans are counted too."""
    import warnings
    from repro_torch.serving.engine import Engine
    side = {}
    for on in (False, True):
        made.clear()
        eng = Engine(cfg, params, device=DEVICE, **ENGINE,
                     tracer=tracer if on else None)
        uids = [eng.submit(p, NEW_TOKENS) for p in prompts]
        side[on] = dict(eng=eng, uids=uids, out={}, syncs=0,
                        spans=len(made), wall_s=0.0, thread_cpu_s=0.0,
                        counts=dict.fromkeys(_read_counts(), 0))

    def busy(eng):
        return bool(len(eng.scheduler) or eng.active_lanes
                    or eng._preempted or eng._pending_results)

    n = 0
    while any(busy(d["eng"]) for d in side.values()):
        for on in ((False, True) if n % 2 == 0 else (True, False)):
            d = side[on]
            if not busy(d["eng"]):
                continue
            made.clear()
            _reset_counts()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                c0, t0 = time.thread_time(), time.monotonic()
                for r in d["eng"].step():
                    d["out"][r.uid] = r
                d["wall_s"] += time.monotonic() - t0
                d["thread_cpu_s"] += time.thread_time() - c0
            d["syncs"] += sum(SYNC_WARNING in str(w.message)
                              for w in caught)
            d["spans"] += len(made)
            for k, v in _read_counts().items():
                d["counts"][k] += v
        n += 1
    for d in side.values():
        d["eng"].finalize_stats()
        d["res"] = [d["out"][u] for u in d["uids"]]
    return side


def phase_obs_serve(torch, cfg, packed, prompts):
    """``obs_serve``: the 12 requests of ``phase_serve`` (phased paged,
    full depth) in ``OBS_ROUNDS`` rounds, each an untraced and a traced
    engine stepped in alternation (``_lockstep``). Every step counts the
    synchronizing CUDA calls PyTorch makes
    (``torch.cuda.set_sync_debug_mode("warn")``: stream and device syncs,
    blocking copies); each engine's count must equal the first's, traced
    or not, as must every stream. No ``Span`` may be constructed in an
    untraced engine's steps (the class is wrapped to count); in a traced
    one the ``decode.slab`` durations sum to ``decode_s`` and the
    ``prefill.chunks`` durations to ``prefill_s`` (1e-9 s), and every
    kernel of the path launches in each. The median over rounds of the
    traced engine's tok/s over the untraced one's must reach
    ``OBS_TOK_FLOOR``. The last round's Chrome trace is written under
    ``build/obs``. Returns the launch counts."""
    from repro_torch.obs import export, trace as trace_mod
    made = []
    orig = trace_mod.Span

    class CountingSpan(orig):
        def __init__(self, *a, **kw):
            made.append(a[0])
            super().__init__(*a, **kw)

    trace_mod.Span = CountingSpan
    rows, counts, first = [], [], None
    try:
        for n in range(OBS_ROUNDS):
            tr = trace_mod.Tracer()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                side = _lockstep(cfg, packed, prompts, tr, made)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            row = {"round": n}
            for on, d in side.items():
                st, res = d["eng"].stats, d["res"]
                what = f"obs_serve round {n} (tracing {on})"
                counts.append(d["counts"])
                gen = [r.generated for r in res]
                check(all(r.ok and g.size == NEW_TOKENS
                          for r, g in zip(res, gen)),
                      f"{what}: a request did not complete")
                if first is None:
                    first = (gen, d["syncs"])
                check(all(np.array_equal(g, f)
                          for g, f in zip(gen, first[0])),
                      f"{what}: a stream changed")
                check(d["syncs"] == first[1] and d["syncs"] > 0,
                      f"{what}: {d['syncs']} synchronizing calls, the "
                      f"first engine made {first[1]}")
                for k in PAGED:
                    check(d["counts"][k] > 0, f"{what}: kernel {k} never "
                                              "launched")
                row["on" if on else "off"] = {
                    "tok_per_s": st["tok_per_s"], "wall_s": d["wall_s"],
                    "thread_cpu_s": d["thread_cpu_s"],
                    "sync_calls": d["syncs"],
                    "spans_constructed": d["spans"]}
            check(side[False]["spans"] == 0,
                  f"obs_serve round {n}: {side[False]['spans']} spans "
                  "constructed with tracing off")
            recs, st = list(tr.records), side[True]["eng"].stats
            check(side[True]["spans"] == len(recs),
                  f"obs_serve: {side[True]['spans']} spans made, "
                  f"{len(recs)} kept")
            slab = sum(r.dur for r in recs if r.name == "decode.slab")
            pre = sum(r.dur for r in recs if r.name == "prefill.chunks")
            check(abs(slab - st["decode_s"]) <= 1e-9
                  and abs(pre - st["prefill_s"]) <= 1e-9,
                  f"obs_serve: spans {slab}/{pre} s against decode_s "
                  f"{st['decode_s']}, prefill_s {st['prefill_s']}")
            row["spans"] = _span_summary(recs)
            row["ratio"] = row["on"]["tok_per_s"] / row["off"]["tok_per_s"]
            rows.append(row)
    finally:
        trace_mod.Span = orig
    os.makedirs(OBS_DIR, exist_ok=True)
    path = export.write_chrome_trace(os.path.join(OBS_DIR, "serve.json"),
                                     recs)
    nbytes = os.path.getsize(path)
    json.loads(open(path).read())
    tps = {k: [r[k]["tok_per_s"] for r in rows] for k in ("off", "on")}
    ratios = [r["ratio"] for r in rows]
    spread = {k: (max(v) - min(v)) / statistics.median(v)
              for k, v in tps.items()}
    emit(phase="obs_serve", requests=len(prompts), new_tokens=NEW_TOKENS,
         rounds=rows, tok_per_s_off=tps["off"], tok_per_s_on=tps["on"],
         tok_per_s_spread=spread, tok_per_s_ratios=ratios,
         tok_per_s_ratio_median=statistics.median(ratios),
         sync_calls=first[1], chrome_trace_bytes=nbytes,
         chrome_trace_events=len(recs))
    check(statistics.median(ratios) >= OBS_TOK_FLOOR,
          f"obs_serve: traced/untraced tok/s {ratios}, median below "
          f"{OBS_TOK_FLOOR}")
    return counts


def _prefix_prompts(cfg, rng):
    """One warm request and 12 sharing its 100-token system prompt, each
    with a distinct 16-48-token suffix."""
    system = rng.integers(0, cfg.vocab_size, size=PREFIX_LEN)
    warm = system.astype(np.int32)
    reqs = [np.concatenate([system, rng.integers(
        0, cfg.vocab_size, size=int(n))]).astype(np.int32)
        for n in rng.integers(16, 49, size=N_REQUESTS)]
    return warm, reqs


def phase_serve_prefix(torch, cfg, packed, warm, reqs):
    """Shared-system-prompt traffic with the prefix cache off and on, in
    the order off, on, on, off. With the cache on, every request matches
    the warm request's 100 tokens: 6 full pages and 4 rows of a seventh,
    which is copied. Returns the launch counts."""
    runs, counts = {}, []
    for on in (False, True, True, False):
        name = "serve_prefix" if on else "serve_prefix_off"
        _, c, st = phase_serve(torch, cfg, name, packed, reqs, PREFIX_TOKENS,
                               PAGED, ("fused_glu_joint",), warm=[warm],
                               prefix_cache=on)
        if on:
            got = (st["prefix_hits"], st["cow_copies"],
                   st["prefill_tokens_skipped"])
            want = (N_REQUESTS, N_REQUESTS, N_REQUESTS * PREFIX_LEN)
            check(got == want, f"prefix cache: hits, copies, skipped "
                               f"{got}, expected {want}")
        runs.setdefault(name, []).append(dict(
            _brief(st), prefill_tokens=st["prefill_tokens"],
            peak_kv_bytes_referenced=st.get("peak_kv_bytes_referenced")))
        counts.append(c)
    emit(phase="serve_prefix_modes", requests=len(reqs),
         prefix_len=PREFIX_LEN, new_tokens=PREFIX_TOKENS,
         order=["off", "on", "on", "off"], runs=runs)
    return counts


def phase_serve_loop(torch, cfg, packed, loop_prompts):
    """``serve_loop.generate`` (token-by-token prefill into the contiguous
    cache, then one decode step per token) on 4 prompts of 64 tokens,
    beside the phased paged engine on the same prompts. All four requests
    get their first token at the end of the prefill, so its TTFT p50 and
    p95 are the prefill's wall time. Returns the launch counts and the
    generated tokens (4, 32)."""
    from repro_torch.serving import serve_loop
    _reset_counts()
    t0 = time.monotonic()
    toks, st = serve_loop.generate(cfg, packed, np.stack(loop_prompts),
                                   max_new_tokens=LOOP_TOKENS, device=DEVICE)
    wall = time.monotonic() - t0
    counts = _read_counts()
    gen = toks[:, LOOP_LEN:]
    ttft = wall - st["decode_s"]
    emit(phase="serve", run="serve_loop", submitted=len(loop_prompts),
         completed=int(gen.shape[0]), tok_per_s=st["tok_per_s"],
         ttft_p50_s=ttft, ttft_p95_s=ttft,
         peak_kv_bytes=_kv_slab_bytes(cfg, len(loop_prompts),
                                      LOOP_LEN + LOOP_TOKENS),
         wall_s=wall, launches=counts)
    check(gen.shape == (len(loop_prompts), LOOP_TOKENS),
          f"serve_loop: {gen.shape} tokens")
    check(bool(((gen >= 0) & (gen < cfg.vocab_size)).all()),
          "serve_loop: token outside the vocabulary")
    check(counts["bspmm"] > 0 and counts["fused_glu_split"] > 0,
          "serve_loop launched no BSpMM kernel")
    check(counts["paged_flash_decode"] == 0 and counts["fused_glu_joint"] == 0,
          "serve_loop launched a paged or joint kernel")
    _, c, _ = phase_serve(torch, cfg, "serve_loop_phased", packed,
                          loop_prompts, LOOP_TOKENS, PAGED,
                          ("fused_glu_joint",))
    return [counts, c], gen


def _first_divergence(got, want):
    n = min(len(got), len(want))
    diff = np.nonzero(np.asarray(got[:n]) != np.asarray(want[:n]))[0]
    return int(diff[0]) if diff.size else None


def phase_parity(torch, cfg, packed, prompts):
    """The engine's KV paths against each other on the model's first two
    layers at full width in f32 (the kernels' FMA loops and f32 paged
    decode): phased paged, contiguous, mixed and prefix-cached phased on
    the same prompts, and ``serve_loop`` on the equal-length ones. Greedy
    streams must be equal; a first divergence is accepted only where the
    phased run's top-2 margin at that step (``_last_logits``) is below
    1e-4. Returns the launch counts."""
    from repro_torch.serving import serve_loop
    cfg2 = dataclasses.replace(cfg, num_layers=PARITY_DEPTH,
                               compute_dtype="float32")
    p2 = _first_layers(packed, PARITY_DEPTH)
    modes = {"phased": ({}, PAGED, ()),
             "contiguous": (dict(paged=False), ("bspmm", "fused_glu_split"),
                            ("paged_flash_decode",)),
             "mixed": (dict(mixed=True), PAGED, ()),
             "prefix": (dict(prefix_cache=True), PAGED, ())}
    streams, counts, stats = {}, [], {}
    for name, (mode, must, must_not) in modes.items():
        _reset_counts()
        eng, res, _ = _serve(cfg2, p2, prompts, PARITY_TOKENS, **mode)
        c = _read_counts()
        for k in must:
            check(c[k] > 0, f"parity {name}: kernel {k} never launched")
        for k in must_not:
            check(c[k] == 0, f"parity {name}: kernel {k} launched")
        check(all(r.ok and r.generated.size == PARITY_TOKENS for r in res),
              f"parity {name}: a request did not complete")
        streams[name] = [r.generated for r in res]
        stats[name] = {k: eng.stats[k] for k in (
            "stalled_decode_steps", "prefix_hits", "cow_copies",
            "prefill_tokens_skipped")}
        counts.append(c)
    equal = [i for i, p in enumerate(prompts) if p.size == LOOP_LEN]
    _reset_counts()
    toks, _ = serve_loop.generate(cfg2, p2,
                                  np.stack([prompts[i] for i in equal]),
                                  max_new_tokens=PARITY_TOKENS, device=DEVICE)
    counts.append(_read_counts())
    loop = {i: toks[j, LOOP_LEN:] for j, i in enumerate(equal)}
    accepted, margins = 0, []
    others = [(n, dict(enumerate(streams[n]))) for n in modes if n != "phased"]
    for name, got in others + [("serve_loop", loop)]:
        for i, g in got.items():
            want = streams["phased"][i]
            t = _first_divergence(g, want)
            if t is None:
                continue
            seq = np.concatenate([prompts[i], want[:t]]).astype(np.int32)
            top2 = torch.topk(_last_logits(torch, cfg2, p2, seq), 2).values
            m = float(top2[0] - top2[1])
            margins.append({"run": name, "request": i, "step": t,
                            "margin": m})
            check(m < NEAR_TIE, f"parity {name} request {i} diverged at "
                                f"step {t}, phased margin {m} >= {NEAR_TIE}")
            accepted += 1
    check(stats["mixed"]["stalled_decode_steps"] == 0,
          "parity mixed: decode stalled")
    check(stats["prefix"]["prefix_hits"] > 0, "parity prefix: no hit")
    emit(phase="parity", depth=PARITY_DEPTH, dtype="float32",
         requests=len(prompts), serve_loop_requests=len(equal),
         new_tokens=PARITY_TOKENS, runs=list(modes) + ["serve_loop"],
         accepted_divergences=accepted, divergences=margins,
         near_tie=NEAR_TIE, stats=stats, launches=counts)
    return counts


# ----------------------------------------------- serving behind traffic
def _pctl(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def _http_get(url):
    import urllib.request
    t0 = time.monotonic()
    with urllib.request.urlopen(url, timeout=10) as f:
        text = f.read().decode()
    return time.monotonic() - t0, text


def _frontdoor_run(torch, cfg, params, batch, inter, sla, scrape=False):
    """The launcher's ``--frontdoor --sla --preempt`` trace through
    ``AsyncEngine``: the batch tier at t = 0, the interactive tier from
    ``FD_FIRST_S`` every ``FD_GAP_S``. ``sla=False`` runs it FIFO, without
    preemption. With ``scrape`` the front door serves ``/metrics``
    (``metrics_port=0``), scraped every ``OBS_SCRAPE_S`` while the trace
    runs and once after it (the engine idle), beside the registry's
    snapshot at that moment. Returns (per-class results, stats, wall
    seconds, scrapes: [(latency s, text)], final snapshot, engine)."""
    import asyncio
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.frontend import AsyncEngine
    from repro_torch.serving.scheduler import (BATCH, INTERACTIVE,
                                               SLAScheduler)
    mb, ml = ENGINE["max_batch"], ENGINE["max_len"]
    eng = Engine(cfg, params, device=DEVICE, **ENGINE, preempt=sla,
                 scheduler=SLAScheduler(mb, ml, aging_s=30) if sla else None)

    async def finish(stream, t_sub):
        res = await stream.result()
        return res, time.monotonic() - t_sub

    async def scraper(url, done, scrapes):
        loop = asyncio.get_running_loop()
        while not done.is_set():
            scrapes.append(await loop.run_in_executor(None, _http_get, url))
            try:
                await asyncio.wait_for(done.wait(), OBS_SCRAPE_S)
            except asyncio.TimeoutError:
                pass

    async def drive():
        tasks, scrapes, final = [], [], None
        async with AsyncEngine(eng, metrics_port=0 if scrape
                               else None) as front:
            if scrape:
                done = asyncio.Event()
                url = "http://%s:%d/metrics" % front.metrics_addr
                job = asyncio.ensure_future(scraper(url, done, scrapes))
            t0 = time.monotonic()
            # submitted together, so one admission fills every lane
            for s in await asyncio.gather(*(
                    front.submit_async(p, FD_BATCH_TOKENS, priority=BATCH)
                    for p in batch)):
                tasks.append(("batch", asyncio.ensure_future(
                    finish(s, t0))))
            for j, p in enumerate(inter):
                await asyncio.sleep(max(
                    0.0, t0 + FD_FIRST_S + j * FD_GAP_S - time.monotonic()))
                s = await front.submit_async(
                    p, FD_INTER_TOKENS, priority=INTERACTIVE,
                    deadline_s=FD_DEADLINE_S)
                tasks.append(("interactive", asyncio.ensure_future(
                    finish(s, time.monotonic()))))
            out = [(cls, *(await t)) for cls, t in tasks]
            wall = time.monotonic() - t0
            if scrape:
                done.set()
                await job
                # every stream finished: the engine thread idles
                final = (await asyncio.get_running_loop().run_in_executor(
                    None, _http_get, url), eng.metrics.snapshot())
        return out, wall, scrapes, final

    out, wall, scrapes, final = asyncio.run(asyncio.wait_for(drive(), 600))
    return out, dict(eng.stats), wall, scrapes, final, eng


def phase_serve_frontdoor(torch, cfg, packed, rng):
    """SLA traffic through the asyncio front door at full depth, bf16: 8
    batch requests (128-token prompts, 256 new tokens) fill every lane at
    t = 0; 6 interactive ones (64 tokens, 16 new, deadline 0.5 s) arrive
    every 0.25 s from t = 0.5 s. With the SLA scheduler and ``preempt``
    each interactive arrival preempts a batch lane, whose KV goes to host
    memory and comes back at its frontier; the same trace runs FIFO
    without preemption. Returns the launch counts."""
    batch = [rng.integers(0, cfg.vocab_size, size=FD_BATCH_PROMPT)
             .astype(np.int32) for _ in range(ENGINE["max_batch"])]
    inter = [rng.integers(0, cfg.vocab_size, size=FD_INTER_PROMPT)
             .astype(np.int32) for _ in range(FD_INTER)]
    counts = []
    for name, sla in (("sla_preempt", True), ("fifo", False)):
        _reset_counts()
        out, st, wall, scrapes, final, eng = _frontdoor_run(
            torch, cfg, packed, batch, inter, sla, scrape=sla)
        c = _read_counts()
        if sla:
            _check_scrapes(scrapes, final, eng)
        counts.append(c)
        classes = {}
        for cls, want in (("batch", FD_BATCH_TOKENS),
                          ("interactive", FD_INTER_TOKENS)):
            rs = [(r, e2e) for k, r, e2e in out if k == cls]
            check(all(r.ok and r.generated.size == want for r, _ in rs),
                  f"frontdoor {name}: a {cls} request did not complete")
            ttft = [r.ttft_s for r, _ in rs]
            classes[cls] = {"requests": len(rs),
                            "ttft_p50_s": _pctl(ttft, 50),
                            "ttft_p95_s": _pctl(ttft, 95),
                            "e2e_p95_s": _pctl([e for _, e in rs], 95)}
        keys = ("preemptions", "restores", "offloaded_pages",
                "restored_pages", "offload_bytes_peak",
                "re_prefilled_tokens", "queue_depth_peak", "queued_s_max",
                "generated_tokens", "stalled_decode_steps")
        emit(phase="serve_frontdoor", run=name, sla=sla, preempt=sla,
             classes=classes, tok_per_s=st["tok_per_s"], wall_s=wall,
             **{k: st[k] for k in keys}, launches=c)
        for k in PAGED:
            check(c[k] > 0, f"frontdoor {name}: kernel {k} never launched")
        check(st["re_prefilled_tokens"] == 0,
              f"frontdoor {name}: {st['re_prefilled_tokens']} tokens "
              "prefilled twice")
        if sla:
            check(st["preemptions"] >= 1, "frontdoor: no preemption")
            check(st["restores"] == st["preemptions"],
                  f"frontdoor: {st['restores']} restores of "
                  f"{st['preemptions']} preemptions")
            check(st["restored_pages"] == st["offloaded_pages"] > 0,
                  f"frontdoor: {st['restored_pages']} pages restored of "
                  f"{st['offloaded_pages']} offloaded")
        else:
            check(st["preemptions"] == 0, "fifo run preempted")
    return counts


def _check_scrapes(scrapes, final, eng):
    """``obs_frontdoor``: every scrape taken while the SLA trace ran
    parses, no counter decreases from one scrape to the next, and the
    scrape taken after the trace (the engine idle) equals the registry's
    snapshot: every scalar, and each summary's count and sum."""
    from repro_torch.obs.metrics import Histogram, parse_prometheus_text
    kinds = {n: eng.metrics[n].kind for n in eng.metrics.names()}
    parsed = [parse_prometheus_text(t) for _, t in scrapes]
    check(len(parsed) >= 3, f"obs_frontdoor: {len(parsed)} scrapes")
    for a, b in zip(parsed, parsed[1:]):
        for n, k in kinds.items():
            if k == "counter" and f"blast_{n}" in a:
                check(b[f"blast_{n}"] >= a[f"blast_{n}"],
                      f"obs_frontdoor: counter {n} fell from "
                      f"{a[f'blast_{n}']} to {b[f'blast_{n}']}")
    (lat_end, text), snap = final
    last = parse_prometheus_text(text)
    for n, v in snap.items():
        if isinstance(eng.metrics[n], Histogram):
            check(last[f"blast_{n}_count"] == v["count"]
                  and last[f"blast_{n}_sum"] == v["sum"],
                  f"obs_frontdoor: {n} {v} against the scrape")
        else:
            check(last[f"blast_{n}"] == v,
                  f"obs_frontdoor: {n} = {v}, scraped {last[f'blast_{n}']}")
    lat = [s for s, _ in scrapes]
    emit(phase="obs_frontdoor", run="sla_preempt", scrapes=len(scrapes),
         scrape_ms=[x * 1e3 for x in lat],
         scrape_p50_ms=statistics.median(lat) * 1e3,
         scrape_max_ms=max(lat) * 1e3, final_scrape_ms=lat_end * 1e3,
         text_bytes=len(text.encode()), metrics=len(snap),
         generated_tokens_scraped=[p.get("blast_generated_tokens")
                                   for p in parsed])


def _near_tie_equal(torch, cfg, params, prompts, got, want, name,
                    tol=NEAR_TIE):
    """Each stream of ``got`` equals ``want``'s, or first diverges where
    ``want``'s model (``params``) has a top-2 margin below ``tol``.
    Returns the accepted divergences."""
    accepted = []
    for u, w in want.items():
        t = _first_divergence(got[u], w)
        if t is None:
            continue
        seq = np.concatenate([prompts[u], w[:t]]).astype(np.int32)
        top2 = torch.topk(_last_logits(torch, cfg, params, seq), 2).values
        m = float(top2[0] - top2[1])
        check(m < tol, f"{name}: request {u} diverged at step {t}, margin "
                       f"{m} >= {tol}")
        accepted.append({"request": u, "step": t, "margin": m})
    return accepted


def _chaos_async(cfg, params, prompts, plan, watchdog_s, tracer=None):
    """``prompts`` through ``AsyncEngine(watchdog_s, max_recoveries=2)``
    over an engine running ``plan`` (and ``tracer``). Returns ({uid:
    result or error}, engine stats, recovery log)."""
    import asyncio
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.frontend import AsyncEngine
    eng = Engine(cfg, params, device=DEVICE, faults=plan, tracer=tracer,
                 **ENGINE)

    async def drive():
        async with AsyncEngine(eng, watchdog_s=watchdog_s,
                               max_recoveries=2) as front:
            streams = await asyncio.gather(*(
                front.submit_async(p, CHAOS_TOKENS) for p in prompts))
            out = {}
            for s in streams:
                try:
                    out[s.uid] = await s.result()
                except Exception as e:          # a request's own failure
                    out[s.uid] = e
            return out, front.recovery_log

    out, log = asyncio.run(asyncio.wait_for(drive(), 600))
    return out, dict(eng.stats), log


def _chaos_sync(cfg, params, prompts, plan, preempt_uid=None, tracer=None):
    """``prompts`` through the engine's own loop; with ``preempt_uid``
    that request's lane is preempted after step 1."""
    from repro_torch.serving.engine import Engine
    eng = Engine(cfg, params, device=DEVICE, faults=plan, tracer=tracer,
                 **ENGINE)
    uids = [eng.submit(p, CHAOS_TOKENS) for p in prompts]
    out = {}
    if preempt_uid is not None:
        for _ in range(2):
            out.update((r.uid, r) for r in eng.step())
        [i] = [i for i in eng.active_lanes
               if eng.lanes[i].req.uid == preempt_uid]
        eng.preempt(i)
    out.update(eng.run())
    return {u: out[u] for u in uids}, dict(eng.stats), []


def phase_serve_chaos(torch, cfg, packed, prompts):
    """Per-request fault containment and crash recovery: 12 requests x 32
    tokens on 8 lanes, on the model's first two layers in f32 (as
    ``phase_parity``), once without faults and once under each seeded
    plan (each fires at step 2, when all 8 lanes decode): (a) NaN logits
    on lane 3, (b) a host-side crash under the watchdog, (c) device loss,
    (d) a corrupted offload record of request 0 preempted by hand, (e) a
    step stalled past the watchdog. Then (b) at full depth in bf16.
    Returns the launch counts."""
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving.faults import FaultPlan, LaneFaultError
    cfg2 = dataclasses.replace(cfg, num_layers=PARITY_DEPTH,
                               compute_dtype="float32")
    p2 = _first_layers(packed, PARITY_DEPTH)
    reqs = prompts[:CHAOS_REQUESTS]
    shutil.rmtree(os.path.join(OBS_DIR, "chaos"), ignore_errors=True)
    tracers = {name: Tracer(postmortem_dir=os.path.join(OBS_DIR, "chaos",
                                                        name))
               for name in ("none", "a_poison", "b_host_crash",
                            "c_device_lost", "d_corrupt_offload", "e_stall",
                            "b_host_crash_full")}
    plans = {
        "none": (lambda tr: _chaos_sync(cfg2, p2, reqs, None, tracer=tr)),
        "a_poison": (lambda tr: _chaos_sync(
            cfg2, p2, reqs, FaultPlan().poison_logits(2, 3), tracer=tr)),
        "b_host_crash": (lambda tr: _chaos_async(
            cfg2, p2, reqs, FaultPlan().crash(2), CHAOS_WATCHDOG_S, tr)),
        "c_device_lost": (lambda tr: _chaos_async(
            cfg2, p2, reqs, FaultPlan().crash(2, device_lost=True),
            CHAOS_WATCHDOG_S, tr)),
        "d_corrupt_offload": (lambda tr: _chaos_sync(
            cfg2, p2, reqs, FaultPlan().corrupt_offload(0), preempt_uid=0,
            tracer=tr)),
        "e_stall": (lambda tr: _chaos_async(
            cfg2, p2, reqs, FaultPlan().stall(2, 10 * CHAOS_WATCHDOG_S),
            CHAOS_WATCHDOG_S, tr)),
    }
    failed_uid = {"a_poison": 3, "d_corrupt_offload": 0}
    counts, base = [], None
    for name, run in plans.items():
        _reset_counts()
        t0 = time.monotonic()
        out, st, log = run(tracers[name])
        wall = time.monotonic() - t0
        c = _read_counts()
        counts.append(c)
        for k in PAGED:
            check(c[k] > 0, f"chaos {name}: kernel {k} never launched")
        ok = {u: r.generated for u, r in out.items()
              if not isinstance(r, Exception) and r.ok}
        failed = {u: (r if isinstance(r, Exception) else r.error)
                  for u, r in out.items() if u not in ok}
        if base is None:
            check(not failed and all(g.size == CHAOS_TOKENS
                                     for g in ok.values()),
                  "chaos: the fault-free run did not complete")
            base = ok
        want_failed = ([failed_uid[name]] if name in failed_uid else [])
        check(sorted(failed) == want_failed,
              f"chaos {name}: failed {sorted(failed)}, expected "
              f"{want_failed}: {failed}")
        for u in want_failed:
            check(isinstance(failed[u], LaneFaultError),
                  f"chaos {name}: {failed[u]!r} is not a LaneFaultError")
        if name == "d_corrupt_offload":
            check("checksum" in failed[0].reason,
                  f"chaos {name}: {failed[0].reason}")
        accepted = _near_tie_equal(torch, cfg2, p2, reqs, ok,
                                   {u: base[u] for u in ok}, f"chaos {name}")
        check(st["faults_injected"] == (0 if name == "none" else 1),
              f"chaos {name}: {st['faults_injected']} faults fired")
        if name in ("b_host_crash", "e_stall"):
            check(st["recovered_zero_reprefill"] >= 1
                  and st["re_prefilled_tokens"] == 0,
                  f"chaos {name}: salvage {st['recovered_zero_reprefill']}"
                  f", re-prefilled {st['re_prefilled_tokens']}")
        if name == "c_device_lost":
            check(st["re_prefilled_tokens"] > 0,
                  "chaos c_device_lost: nothing re-prefilled")
        if name == "e_stall":
            check(st["watchdog_hangs"] == 1,
                  f"chaos e_stall: {st['watchdog_hangs']} hangs")
        emit(phase="serve_chaos", run=name, depth=PARITY_DEPTH,
             dtype="float32", requests=len(reqs), new_tokens=CHAOS_TOKENS,
             failed={str(u): repr(e) for u, e in failed.items()},
             accepted_divergences=accepted, wall_s=wall,
             recovery_log=log, launches=c,
             **{k: st[k] for k in (
                 "faults_injected", "lanes_quarantined", "recoveries",
                 "recovered_zero_reprefill", "re_prefilled_tokens",
                 "watchdog_hangs", "engine_crashes", "preemptions",
                 "offloaded_pages", "restored_pages")})
    # (b) at full depth in bf16: recovery latency and salvaged bytes
    _reset_counts()
    full, _, _ = _chaos_sync(cfg, packed, reqs, None)
    t0 = time.monotonic()
    out, st, log = _chaos_async(cfg, packed, reqs, FaultPlan().crash(2),
                                CHAOS_WATCHDOG_FULL_S,
                                tracers["b_host_crash_full"])
    wall = time.monotonic() - t0
    c = _read_counts()
    counts.append(c)
    check(all(not isinstance(r, Exception) and r.ok
              for r in out.values()), "chaos full depth: a request failed")
    accepted = _near_tie_equal(torch, cfg, packed, reqs,
                               {u: r.generated for u, r in out.items()},
                               {u: r.generated for u, r in full.items()},
                               "chaos b_host_crash full depth")
    check(len(log) == 1 and st["re_prefilled_tokens"] == 0
          and st["recovered_zero_reprefill"] >= 1,
          f"chaos full depth: log {log}, stats {st}")
    emit(phase="serve_chaos", run="b_host_crash", depth=cfg.num_layers,
         dtype="bfloat16", requests=len(reqs), new_tokens=CHAOS_TOKENS,
         recovery_latency_s=log[0]["latency_s"],
         salvaged_lanes=log[0]["salvaged_lanes"],
         salvaged_bytes=log[0]["salvaged_bytes"],
         accepted_divergences=accepted, wall_s=wall, launches=c,
         **{k: st[k] for k in ("recoveries", "recovered_zero_reprefill",
                               "re_prefilled_tokens", "engine_crashes",
                               "offloaded_pages", "restored_pages")})
    _check_chaos_postmortems(tracers)
    return counts


def _postmortem_rows(tr, directory):
    """Each postmortem of ``tr`` as a printable row, checked against the
    file the tracer wrote for it under ``directory``."""
    files = sorted(os.listdir(directory)) if os.path.isdir(directory) else []
    check(files == [f"postmortem_{i:04d}_{p['reason']}.json"
                    for i, p in enumerate(tr.postmortems)],
          f"obs_postmortems: files {files} for "
          f"{[p['reason'] for p in tr.postmortems]}")
    for f, p in zip(files, tr.postmortems):
        with open(os.path.join(directory, f)) as fh:
            check(json.load(fh)["reason"] == p["reason"],
                  f"obs_postmortems: {f} does not hold its reason")
    return [{"reason": p["reason"], "records": len(p["spans"]),
             "meta": {k: v for k, v in p["meta"].items()
                      if k in ("error", "device_lost", "active_uids",
                               "open_streams", "cause", "bad_gen",
                               "restored_gen", "step", "consecutive")}}
            for p in tr.postmortems]


def _uid_in(spans, uid):
    return any(s["attrs"].get("uid") == uid
               or uid in (s["attrs"].get("uids") or ()) for s in spans)


def _check_chaos_postmortems(tracers):
    """``obs_postmortems`` of the chaos plans: the reasons the reference
    gives for each (a watchdog dump, then the supervisor's, for a crash,
    a device loss and a hang; none for a quarantine, which is an event),
    the uids on lanes at the crash threading the frozen records, and the
    quarantined victims' own timelines."""
    want = {"none": [], "a_poison": [], "d_corrupt_offload": [],
            "b_host_crash": ["watchdog_crash", "supervisor_recover"],
            "c_device_lost": ["watchdog_crash", "supervisor_recover"],
            "e_stall": ["watchdog_hang", "supervisor_recover"],
            "b_host_crash_full": ["watchdog_crash", "supervisor_recover"]}
    rows = {}
    for name, tr in tracers.items():
        reasons = [p["reason"] for p in tr.postmortems]
        check(reasons == want[name],
              f"obs_postmortems {name}: reasons {reasons}")
        for p in tr.postmortems:
            if p["reason"] == "supervisor_recover":
                uids = p["meta"]["active_uids"]
                check(uids and all(_uid_in(p["spans"], u) for u in uids),
                      f"obs_postmortems {name}: uids {uids} not in the "
                      "frozen records")
        rows[name] = _postmortem_rows(tr, os.path.join(OBS_DIR, "chaos",
                                                       name))
    for name, uid, tail in (
            ("a_poison", 3, ["request.quarantined"]),
            ("d_corrupt_offload", 0,
             ["offload.corrupt", "request.quarantined"])):
        got = [s["name"] for s in tracers[name].spans_for(uid)]
        check(got[0] == "request.queued" and got[-len(tail):] == tail,
              f"obs_postmortems {name}: victim {uid}'s timeline {got}")
        rows[name] = [{"victim": uid, "timeline_tail": got[-len(tail):],
                       "records": len(got)}]
    emit(phase="obs_postmortems", drive="serve_chaos", runs=rows)


def _last_logits(torch, cfg, params, prompt, dist=None):
    """Next-token logits after ``prompt``: one single-lane prefill chunk
    through the same model functions the engine calls (with ``dist``,
    tensor-parallel on this rank's shard, the vocab shards gathered)."""
    from repro_torch.models import transformer
    kw = {} if dist is None else {"dist": dist}
    ps = ENGINE["page_size"]
    pages = -(-len(prompt) // ps)
    cache = transformer.init_paged_cache(cfg, pages, ps, device=DEVICE, **kw)
    with torch.inference_mode():
        logits, _ = transformer.paged_prefill_chunk(
            cfg, params, cache,
            torch.as_tensor(prompt, device=DEVICE)[None], 0,
            torch.zeros(1, dtype=torch.int32, device=DEVICE),
            torch.arange(pages, dtype=torch.int32, device=DEVICE)[None],
            read_pages=pages, **kw)
        last = logits[0, -1:]
        if dist is not None and dist.shards(cfg.vocab_size):
            last = dist.all_gather(last, dim=-1)
    return last[0].float()


def _first_layers(tree, n):
    """The params of the model's first ``n`` layers (views); a
    local/global model's stacks hold n // 2 (local, global) pairs."""
    from repro_torch.core.packing import PackedBCSC
    out = {}
    for k, v in tree.items():
        if not k.startswith("layers"):
            out[k] = v
            continue
        if k != "layers":
            out[k] = _first_layers({"layers": v}, n // 2)["layers"]
            continue
        out[k] = {}
        for name, sub in v.items():
            if isinstance(sub, dict):
                out[k][name] = {
                    a: (PackedBCSC(b.blocks[:n], b.idx[:n], b.kb, b.joint)
                        if isinstance(b, PackedBCSC) else b[:n])
                    for a, b in sub.items()}
            else:
                out[k][name] = sub[:n]
    return out


def _mlp_inputs(torch, cfg, params, prompts):
    """The hidden state entering every layer's MLP, per prompt, recorded
    from a prefill through ``params`` (one entry per prompt and layer)."""
    from repro_torch.models import transformer
    seen = []
    forward = transformer.mlp_forward

    def recording(cfg_, p, x, masks=None, **kw):
        seen.append(x.clone())
        return forward(cfg_, p, x, masks, **kw)

    transformer.mlp_forward = recording
    try:
        for p in prompts:
            _last_logits(torch, cfg, params, p)
    finally:
        transformer.mlp_forward = forward
    return seen


def phase_e2e(torch, cfg, packed, dense, prompts):
    """Packed (kernels) against pruned-dense (plain torch.matmul MLP) on
    the served prompts.

    The checks:

    * every layer, teacher-forced: on the hidden states the dense model
      feeds each of the 16 MLPs, the packed MLP (fused GLU + BSpMM
      kernels) must match the dense MLP within 2**-5 of the output's
      magnitude (4 bf16 ulps at the top: the dense path rounds gate, up,
      the activation and the product to bf16, the kernels only h);
    * end to end through the engine on the model's first 2 layers (same
      weights): next-token logits within 2**-5 of their magnitude, and
      the first generated token equal wherever the dense logits' top-2
      margin exceeds twice that tolerance;
    * at full depth, the next-token logits of the first 4 prompts within
      2**-5 of their magnitude (printed beside dense bf16 vs dense f32).
      With the reference's init, whose attention weights were 8-16x too
      large, the random network was chaotic in depth and this could not
      hold; the port's init uses the true fan-in (models/params.py)."""
    from repro_torch.models import transformer
    hs = _mlp_inputs(torch, cfg, dense, prompts)
    worst, n = 0.0, cfg.num_layers
    with torch.inference_mode():
        for i, h in enumerate(hs):
            lp = transformer._layer_view(packed["layers"], i % n)["mlp"]
            ld = transformer._layer_view(dense["layers"], i % n)["mlp"]
            yp = transformer.mlp_forward(cfg, lp, h)[0].float()
            yd = transformer.mlp_forward(cfg, ld, h)[0].float()
            check(bool(torch.isfinite(yp).all()), "non-finite packed MLP")
            tol = 2.0 ** -5 * float(yd.abs().max())
            err = float((yp - yd).abs().max())
            worst = max(worst, err / tol)
            check(err <= tol, f"layer {i % n} MLP: packed vs dense differ "
                              f"by {err} > {tol}")
    emit(phase="e2e_layers", layers=n, prompts=len(prompts),
         checked=len(hs), max_err_over_tol=worst, tol_fraction=2.0 ** -5)

    depth = 2
    cfg2 = dataclasses.replace(cfg, num_layers=depth)
    p2, d2 = _first_layers(packed, depth), _first_layers(dense, depth)
    _reset_counts()
    _, packed_res, _ = _serve(cfg2, p2, prompts, 1)
    counts = _read_counts()
    _reset_counts()
    _, dense_res, _ = _serve(cfg2, d2, prompts, 1)
    dense_counts = _read_counts()
    check(counts["bspmm"] > 0 and counts["fused_glu_split"] > 0,
          "the packed prefix run launched no BSpMM kernel")
    check(dense_counts["bspmm"] == 0 and dense_counts["fused_glu_split"] == 0,
          "the dense prefix run launched a BSpMM kernel")
    worst, scale, exempt, compared = 0.0, 0.0, 0, 0
    for p, pr, dr in zip(prompts, packed_res, dense_res):
        lp = _last_logits(torch, cfg2, p2, p)
        ld = _last_logits(torch, cfg2, d2, p)
        check(bool(torch.isfinite(lp).all()), "non-finite packed logits")
        mag = float(ld.abs().max())
        tol = 2.0 ** -5 * mag
        err = float((lp - ld).abs().max())
        worst, scale = max(worst, err / tol), max(scale, mag)
        check(err <= tol, f"packed vs dense logits differ by {err} > {tol}")
        top2 = torch.topk(ld, 2).values
        if float(top2[0] - top2[1]) > 2 * tol:
            compared += 1
            check(int(pr.generated[0]) == int(dr.generated[0]),
                  "first generated token differs outside a near-tie")
        else:
            exempt += 1
    full, full_mag = 0.0, 0.0
    for p in prompts[:4]:
        ld = _last_logits(torch, cfg, dense, p)
        full = max(full, float((_last_logits(torch, cfg, packed, p)
                                - ld).abs().max()))
        full_mag = max(full_mag, float(ld.abs().max()))
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    chaos = max(float((_last_logits(torch, cfg, dense, p)
                       - _last_logits(torch, cfg32, dense, p)).abs().max())
                for p in prompts[:4])
    emit(phase="e2e_logits", depth=depth, requests=len(prompts),
         max_err_over_tol=worst, logit_magnitude=scale,
         tol_fraction=2.0 ** -5, first_tokens_compared=compared,
         exempt_near_ties=exempt, packed_launches=counts,
         dense_launches=dense_counts,
         full_depth_packed_vs_dense_max_abs=full,
         full_depth_logit_magnitude=full_mag,
         full_depth_dense_bf16_vs_f32_max_abs=chaos)
    check(full <= 2.0 ** -5 * full_mag,
          f"full-depth packed vs dense logits differ by {full} at "
          f"magnitude {full_mag}")


def phase_profile(torch, cfg, packed, prompts):
    """Where a decode step's time goes: two pure-decode slabs of 8 lanes
    under torch.profiler (the admission, prefill and first slab run
    before the window). Device time is the sum of the GPU kernels' own
    time; the busy share divides it by the window's wall time, which the
    profiler's CPU-side tracing lengthens. Reported as not measured when
    the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.engine import Engine
    k = ENGINE["slab_k"]
    eng = Engine(cfg, packed, device=DEVICE, **ENGINE)
    for p in prompts[:ENGINE["max_batch"]]:
        eng.submit(p, 1 + 3 * k)
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        eng.step()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    emit(phase="profile", decode_steps=2 * k, lanes=ENGINE["max_batch"],
         wall_ms=wall_ms, step_ms=wall_ms / (2 * k),
         device_ms=dev_ms if dev_ms > 0 else "not measured",
         device_busy_share=dev_ms / wall_ms if dev_ms > 0
         else "not measured",
         top=[{"kernel": e.key[:90], "count": e.count,
               "device_ms": e.self_device_time_total / 1e3} for e in top])


def phase_kernels_t(torch, card, packed):
    """The transposed BSpMM against its plain version on the card, at the
    training shapes: dY (M, 8192) -> dX (M, 2048) through layer 0's
    packed gate (Kb = 16, 256 visits) and dY (M, 2048) -> dX (M, 8192)
    through its packed down (Kb = 64, 208 visits), M in {5, 128, 1024},
    bf16 and f32; then, at M = 128 on the down shape, a balanced mask
    with block-rows 0 and 5 never visited and a global-selection mask
    that packs zero padding at idx 0. Library yardstick: torch.matmul of
    dY by the unpacked pruned weight's transpose. Returns the summary at
    M = 1024, bf16, gate shape (8 sequences of 128 tokens)."""
    from repro_torch.core import topk
    from repro_torch.core.packing import PackedBCSC, pack, unpack
    from repro_torch.core.prune_grow import BlastSpec, initial_mask
    from repro_torch.kernels import bspmm_t as kt, ops
    timer = Timer(torch)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    mlp0 = {k: v.layer(0) for k, v in packed["layers"]["mlp"].items()}
    w = torch.randn(8192, 2048, generator=gen, device=DEVICE)
    hole = w.clone()
    hole[:128] = 0.0
    hole[5 * 128:6 * 128] = 0.0
    spec = BlastSpec(b_in=128, b_out=128, s_init=0.8)
    norms = topk.block_norms(w, 128, 128)
    glob = topk.topk_mask_global(norms, norms.numel() // 5)
    extra = {}
    for name, (wt, m) in {"down_empty_rows": (hole, initial_mask(spec, hole)),
                          "down_global": (w, glob)}.items():
        extra[name] = (pack(topk.apply_block_mask(wt, m, 128, 128), m, 128,
                            128), int(m.sum()))
    visited = set(extra["down_empty_rows"][0].idx.reshape(-1).tolist())
    check(not {0, 5} & visited, "the empty-rows mask visits rows 0 or 5")
    check(bool((extra["down_global"][0].idx == 0).sum()
               > extra["down_global"][0].nb), "the global mask is not padded")
    cases = [("gate", mlp0["w_gate"], None, m) for m in (5, 128, 1024)]
    cases += [("down", mlp0["w_down"], None, m) for m in (5, 128, 1024)]
    cases += [(k, p, n, 128) for k, (p, n) in extra.items()]
    summary = None
    for dt in (torch.bfloat16, torch.float32):
        es = 2 if dt == torch.bfloat16 else 4
        key = "bf16" if dt == torch.bfloat16 else "f32"
        for name, p0, kept, m in cases:
            p = PackedBCSC(p0.blocks.to(dt).contiguous(), p0.idx, p0.kb)
            kept = p.nb * p.nnz if kept is None else kept
            plan = kt.device_plan(p.idx, p.kb)
            wt_dense = unpack(p).t()
            dy = torch.randn(m, p.nb * p.b_out, generator=gen,
                             device=DEVICE).to(dt)
            lp = kt.launch_plan(dy, p, plan)
            k_fn = lambda: ops.bspmm_t(dy, p, plan)  # noqa: E731
            p_fn = lambda: ops.bspmm_t_plain(dy, p)  # noqa: E731
            l_fn = lambda: torch.matmul(dy, wt_dense)  # noqa: E731
            got, want = k_fn(), p_fn()
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = ulp_tol(torch, want, dt)
            nbytes = (dy.numel() * es + p.blocks.numel() * es
                      + plan.visits.numel() * 4
                      + plan.bounds[lp.splits - 1].numel() * 4
                      + m * p.kb * p.b_in * es)
            ops_ = 2 * m * kept * p.b_in * p.b_out
            b_ms, b_by = bound_ms(card, nbytes, ops_, key)
            row = dict(max_abs_err=err, tol=tol, ms=timer.ms(k_fn),
                       plain_ms=timer.ms(p_fn), library_ms=timer.ms(l_fn),
                       bound_ms=b_ms, bound_by=b_by, shape=[m, name],
                       dtype=key, plan=lp.describe(),
                       visits_max=plan.max_len,
                       rows_never_visited=int((plan.lengths == 0).sum()))
            emit(phase="kernel", name="bspmm_t", **row)
            check(err <= tol and math.isfinite(err),
                  f"bspmm_t {key} {name} M={m}: max abs err {err} > {tol}")
            if name == "down_empty_rows":
                check(not bool(got.reshape(m, p.kb, 128)[:, [0, 5]].any()),
                      "bspmm_t wrote non-zeros into never-visited rows")
            if key == "bf16" and name == "gate" and m == 1024:
                summary = row
    return summary


def _grad_history(torch, v) -> dict:
    """AdamW's second moment ``v`` (a tree) summed per layer (the first
    dim of a leaf under 'layers') or whole, in f64 on the device: {path:
    (n,) tensor}. ``v`` accumulates the squared clipped and masked
    gradients, so each entry is one layer's gradient history, which a
    fault in a few leaves moves while the loss and the global norm barely
    do."""
    from repro_torch.checkpointing.checkpoint import flatten_tree
    return {p: (x.flatten(1).sum(1, dtype=torch.float64)
                if p.startswith("layers/") else
                x.sum(dtype=torch.float64)[None])
            for p, x in flatten_tree(v).items()}


def _record_steps(train_loop, torch, history_until=0):
    """Wrap the loop's step factory so every step's (step, new masks) is
    kept, and a CUDA event pair brackets each step's device work (start
    recorded before the step, end after its last kernel was queued; no
    sync); the steps before ``history_until`` also keep the new state's
    ``_grad_history`` (device tensors) in ``seen``'s third place (else
    None). Returns (seen, event pairs, restore)."""
    seen, events = [], []
    make = train_loop.step_mod.make_train_step

    def recording(*a, **kw):
        fn = make(*a, **kw)

        def step(state, batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            new, metrics = fn(state, batch)
            end.record()
            events.append((start, end))
            seen.append((state.step, new.masks,
                         _grad_history(torch, new.opt_state["v"])
                         if state.step < history_until else None))
            return new, metrics
        return step

    train_loop.step_mod.make_train_step = recording
    return seen, events, lambda: setattr(train_loop.step_mod,
                                         "make_train_step", make)


def phase_train(torch, cfg):
    """12 steps of the BLaST trainer on full-width, full-depth
    Llama-3.2-1B (f32 params, bf16 compute, remat per layer): masked
    dense with in-step prune-and-grow every 4 steps toward s = 0.8 by
    step 12 (launch/train.py's overrides of total_steps, its warmup and
    guard). The peak learning rate is AdamWConfig's default, 3e-4:
    launch/train.py's CLI default of 3e-3 is sized for the smoke configs
    and makes a full-width 1B model's loss oscillate upward."""
    from repro_torch.core import sparse_mlp as sm, topk
    from repro_torch.core.schedule import keep_count, sparsity_at
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import registry
    from repro_torch.obs.trace import Tracer
    from repro_torch.optim import adamw
    from repro_torch.training import train_loop
    cfg = dataclasses.replace(cfg, blast=dataclasses.replace(
        cfg.blast, total_steps=TRAIN_STEPS, step_size=TRAIN_STEP_SIZE))
    src = SyntheticLM(cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=SEED)
    opt = adamw.AdamWConfig(total_steps=TRAIN_STEPS,
                            warmup_steps=max(TRAIN_STEPS // 20, 5))
    loop = train_loop.TrainLoopConfig(total_steps=TRAIN_STEPS, log_every=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seen, events, restore = _record_steps(train_loop, torch,
                                          TRAIN_TP_STEPS)
    # the block scores of train_tp's refreshes, by path (device tensors,
    # no sync): the reference that its masks are judged against
    scores, refresh = {}, sm.refresh_masks

    def recording(spec, params, dense_grads, masks, step, *a, **kw):
        if step < TRAIN_TP_STEPS:
            for path in masks:
                bi, bo = sm.block_dims_for(spec, path)
                scores.setdefault(step, {})[path] = (
                    dataclasses.replace(spec, b_in=bi, b_out=bo),
                    *(topk.block_norms(sm.get_path(t, path), bi, bo)
                      for t in (params, dense_grads)))
        return refresh(spec, params, dense_grads, masks, step, *a, **kw)

    sm.refresh_masks = recording
    tr = Tracer()
    _reset_counts()
    t0 = time.monotonic()
    try:
        state, hist = train_loop.train(
            cfg, opt, src, loop, device=DEVICE, seed=SEED, tracer=tr,
            log_fn=lambda m: None)
    finally:
        restore()
        sm.refresh_masks = refresh
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = [h for h in hist if "event" not in h]
    losses = [h["loss"] for h in steps]
    step_s = [h["sec_per_step"] for h in steps[1:]]
    med = statistics.median(step_s)
    tokens = TRAIN_SEQ * TRAIN_BATCH
    emit(phase="train", config=cfg.name, layers=cfg.num_layers,
         steps=TRAIN_STEPS, tokens_per_step=tokens,
         params=registry.count_params(cfg), losses=losses,
         grad_norms=[h["grad_norm"] for h in steps],
         sparsity_final=float(steps[-1]["sparsity"]),
         anomalies=sum(int(h["anomaly"]) for h in steps),
         first_step_s=steps[0]["sec_per_step"], median_step_ms=med * 1e3,
         tokens_per_s=tokens / med, wall_s=wall,
         max_memory_allocated_bytes=peak, launches=counts)
    check(len(steps) == TRAIN_STEPS, f"{len(steps)} logged steps")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(not any(counts.values()), f"training launched kernels: {counts}")
    _check_train_spans(tr, [s.elapsed_time(e) / 1e3 for s, e in events],
                       "train", med)
    spec, flags = cfg.blast, registry.dense_layer_flags(cfg)
    refreshes = []
    for step, masks, _ in seen:
        if step % TRAIN_STEP_SIZE:
            continue
        s = sparsity_at(step, s_init=spec.s_init, s_max=spec.s_max,
                        total_steps=spec.total_steps, decay=spec.decay)
        kept = {}
        for path, m in masks.items():
            per_col = m.sum(dim=-2).cpu()                  # (L, Nb)
            want = keep_count(s, m.shape[-2])
            check(bool((per_col[~flags] == want).all()),
                  f"step {step} {path}: kept per column "
                  f"{per_col[~flags].unique().tolist()} != {want}")
            check(bool(m[flags.to(m.device)].all()),
                  f"{path}: a dense_last layer pruned")
            kept[path.split("/")[-1]] = want
        refreshes.append({"step": step, "sparsity": s, "kept_per_col": kept})
    check(len(refreshes) == 3, f"refreshes seen: {refreshes}")
    for path, mask in state.masks.items():
        bi, bo = sm.block_dims_for(spec, path)
        pruned = ~topk.expand_mask(mask, bi, bo)
        for tree, name in ((state.params, "params"),
                           (state.opt_state["m"], "m"),
                           (state.opt_state["v"], "v")):
            check(not bool(sm.get_path(tree, path)[pruned].any()),
                  f"{path}: pruned blocks not zero in {name}")
    emit(phase="train_refreshes", refreshes=refreshes)
    ref = {"losses": losses[:TRAIN_TP_STEPS],
           "grad_norms": [h["grad_norm"] for h in steps][:TRAIN_TP_STEPS],
           "masks": {st: {p: m.cpu() for p, m in masks.items()}
                     for st, masks, _ in seen if st < TRAIN_TP_STEPS
                     and st % TRAIN_STEP_SIZE == 0},
           "history": [{p: x.cpu().numpy() for p, x in hist.items()}
                       for _, _, hist in seen[:TRAIN_TP_STEPS]],
           "scores": {st: {p: (sp, wn.cpu(), gn.cpu())
                           for p, (sp, wn, gn) in by_path.items()}
                      for st, by_path in scores.items()}}
    return cfg, opt, src, state, ref


def _check_train_spans(tr, device_s, run, med=None):
    """``obs_train``: one ``train.step`` span per step, in order. What
    shows that the loop's ``dt`` covers the whole step on the device is
    ``device_s``, each step's CUDA event pair (start before the step, end
    after its last kernel, AdamW's included): no span may be shorter, and
    the spans' median over all steps but the first lies within
    ``OBS_STEP_TOL`` of the pairs' median, as it does of ``med``, the
    train phase's ``median_step_ms`` (taken from the same ``dt``s), when
    given. ``dt`` ends at the metrics' read, every step, logged or not:
    the sparsity, a device scalar made after the update."""
    spans = [r for r in tr.records if r.name == "train.step"]
    n = len(device_s)
    check([r.attrs["step"] for r in spans] == list(range(n)),
          f"obs_train {run}: spans for steps "
          f"{[r.attrs['step'] for r in spans]}, {n} event pairs")
    span_med = statistics.median(r.dur for r in spans[1:])
    dev_med = statistics.median(device_s[1:])
    short = [(r.attrs["step"], r.dur, d) for r, d in zip(spans, device_s)
             if r.dur < d]
    extra = {} if med is None else dict(median_step_ms=med * 1e3,
                                        span_over_step=span_med / med)
    emit(phase="obs_train", run=run, steps=n,
         train_step_span_median_ms=span_med * 1e3,
         device_step_median_ms=dev_med * 1e3,
         span_ms=[r.dur * 1e3 for r in spans],
         device_step_ms=[d * 1e3 for d in device_s],
         span_over_device=span_med / dev_med, **extra,
         closing_read="every step's metrics float() (sparsity, a device "
                      "scalar made after the update)",
         records={k: sum(r.name == k for r in tr.records)
                  for k in sorted({r.name for r in tr.records})})
    check(med is None or abs(span_med - med) <= OBS_STEP_TOL * med,
          f"obs_train {run}: span median {span_med} against step median "
          f"{med}")
    check(not short, f"obs_train {run}: spans shorter than the step's "
                     f"device work (step, span, device): {short}")
    check(abs(span_med - dev_med) <= OBS_STEP_TOL * dev_med,
          f"obs_train {run}: span median {span_med} against the device "
          f"step median {dev_med}")


def phase_obs_train_unlogged(torch, cfg, opt, src, state):
    """``obs_train`` at the loop's default ``log_every`` (10):
    ``OBS_UNLOGGED_STEPS`` more traced steps from the trained state, of
    which only the first and the last two are logged; each step's
    ``train.step`` span must still cover its CUDA event pair."""
    from repro_torch.obs.trace import Tracer
    from repro_torch.training import train_loop
    loop = train_loop.TrainLoopConfig(total_steps=OBS_UNLOGGED_STEPS)
    _, events, restore = _record_steps(train_loop, torch)
    tr = Tracer()
    try:
        _, hist = train_loop.train(cfg, opt, src, loop, state=state,
                                   device=DEVICE, tracer=tr,
                                   log_fn=lambda m: None)
    finally:
        restore()
    logged = [h["step"] for h in hist if "event" not in h]
    check(loop.log_every == 10 and logged == [0, 10, 11],
          f"obs_train log_every {loop.log_every}: logged steps {logged}")
    _check_train_spans(tr, [s.elapsed_time(e) / 1e3 for s, e in events],
                       "log_every_10")


def phase_train_profile(torch, cfg, opt, src, state):
    """Where a training step's time goes: two more steps of the trained
    state under torch.profiler, a refresh step (12) and a plain one (13).
    Device time is the sum of the GPU kernels' own time; the busy share
    divides it by the step's wall time, which the profiler's CPU-side
    tracing lengthens. GEMM kernels are those whose name says gemm,
    xmma, cutlass or nvjet (cuBLAS's); the rest are elementwise,
    reductions and copies."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training import step as step_mod
    fn = step_mod.make_train_step(cfg, opt)
    for i in range(2):
        batch = {k: torch.as_tensor(v, device=DEVICE)
                 for k, v in src.batch(state.step).items()}
        refresh = state.step % cfg.blast.step_size == 0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            state, _ = fn(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
        gemm_ms = sum(e.self_device_time_total for e in kern if any(
            w in e.key.lower()
            for w in ("gemm", "xmma", "cutlass", "nvjet"))) / 1e3
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
        emit(phase="train_profile", step=state.step - 1, refresh=refresh,
             wall_ms=wall_ms,
             device_ms=dev_ms if dev_ms > 0 else "not measured",
             gemm_device_ms=gemm_ms if dev_ms > 0 else "not measured",
             device_busy_share=dev_ms / wall_ms if dev_ms > 0
             else "not measured",
             kernel_launches=sum(e.count for e in kern),
             top=[{"kernel": e.key[:90], "count": e.count,
                   "device_ms": e.self_device_time_total / 1e3}
                  for e in top])


def _train_mlp_inputs(torch, cfg, state, tokens):
    """The hidden state entering every layer's MLP in a no-grad forward
    of the trained model (one (M, d) matrix per layer)."""
    from repro_torch.models import transformer
    seen = []
    forward = transformer.mlp_forward

    def recording(cfg_, p, x, masks=None, **kw):
        seen.append(x.reshape(-1, x.shape[-1]).clone())
        return forward(cfg_, p, x, masks, **kw)

    transformer.mlp_forward = recording
    try:
        with torch.no_grad():
            transformer.forward(cfg, state.params, tokens,
                                masks=state.masks)
    finally:
        transformer.mlp_forward = forward
    return seen


def phase_finetune_packed(torch, cfg, state, batch):
    """The paper's fine-tuning stage at fixed masks, against the trainer.
    Every layer's gate, up and down are packed with that layer's trained
    mask; on that layer's MLP input from one batch (8 x 128 tokens), the
    gradient of sum(Y * C) (C seeded) through three make_bspmm_trainable
    products (forward bspmm, dX bspmm_t, dBlocks gathered) is held
    against the gradient through the trainer's masked-dense STE GLU: dX
    everywhere, dW at every kept block. f32 within 1e-4 and bf16 within
    2**-5 of each gradient's magnitude (bf16 rounds gate, up, the
    activation, the product and each partial gradient on both sides,
    from f32 sums taken in other orders). Counters reset before each
    dtype's 16 layers and read after: bspmm and bspmm_t 48 each."""
    from repro_torch.core import sparse_mlp as sm
    from repro_torch.core.packing import pack
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    hs = _train_mlp_inputs(torch, cfg, state,
                           torch.as_tensor(batch["tokens"], device=DEVICE))
    check(len(hs) == cfg.num_layers, f"{len(hs)} MLP inputs recorded")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    leaves = ("w_gate", "w_up", "w_down")
    spec = cfg.blast
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        key = "bf16" if dt == torch.bfloat16 else "f32"
        frac = 1e-4 if dt == torch.float32 else 2.0 ** -5
        worst, nnz_l = {"dx": 0.0, "dw": 0.0}, {}
        _reset_counts()
        for i, h in enumerate(hs):
            p_l = transformer._layer_view(state.params["layers"], i)["mlp"]
            m_l = transformer._layer_masks(
                {k: v[i] for k, v in state.masks.items()}, "layers")
            x = h.to(dt).contiguous()
            c = torch.randn(x.shape, generator=gen, device=DEVICE)
            # the trainer's masked-dense STE GLU
            xd = x.clone().requires_grad_()
            ws = [p_l[k].detach().requires_grad_() for k in leaves]
            y = sm.glu_mlp(xd, *ws, act=cfg.mlp_act, masks=m_l, spec=spec)
            dense = torch.autograd.grad((y.float() * c).sum(), [xd, *ws])
            # three trainable packed products
            fs, blocks = [], []
            for k, w in zip(leaves, ws):
                bi, bo = sm.block_dims_for(spec, "layers/mlp/" + k)
                pk = pack(w.detach().to(dt), m_l[k], bi, bo)
                fs.append((ops.make_bspmm_trainable(pk.idx, pk.kb), pk))
                blocks.append(pk.blocks.requires_grad_())
                nnz_l.setdefault(k, []).append(pk.nnz)
            xp = x.clone().requires_grad_()
            hg = fs[0][0](xp, blocks[0])
            hu = fs[1][0](xp, blocks[1])
            yp = fs[2][0](sm.act_fn(cfg.mlp_act)(hg) * hu, blocks[2])
            packed = torch.autograd.grad((yp.float() * c).sum(),
                                         [xp, *blocks])
            checks = [("dx", packed[0], dense[0])]
            for (_, pk), db, dw in zip(fs, packed[1:], dense[1:]):
                nb, nnz, bi, bo = pk.blocks.shape
                dwb = dw.reshape(pk.kb, bi, nb, bo).permute(2, 0, 1, 3)
                cols = torch.arange(nb, device=DEVICE)[:, None]
                checks.append(("dw", db, dwb[cols, pk.idx.long()]))
            for what, got, want in checks:
                tol = frac * float(want.float().abs().max())
                err = float((got.float() - want.float()).abs().max())
                check(math.isfinite(err) and err <= tol,
                      f"layer {i} {key} {what}: err {err} > tol {tol}")
                worst[what] = max(worst[what], err / tol)
        torch.cuda.synchronize()
        counts = _read_counts()
        n = 3 * cfg.num_layers
        check(counts["bspmm"] == n and counts["bspmm_t"] == n,
              f"{key}: bspmm {counts['bspmm']}, bspmm_t {counts['bspmm_t']}"
              f" launches, expected {n} each")
        check(not any(v for k, v in counts.items()
                      if k not in ("bspmm", "bspmm_t")),
              f"{key}: other kernels launched: {counts}")
        out[key] = counts
        emit(phase="finetune_packed", dtype=key, layers=len(hs),
             rows=int(hs[0].shape[0]), tol_fraction=frac,
             max_err_over_tol=worst, launches=counts,
             nnz_per_layer=nnz_l)
    return out


# ------------------------------------ artifacts, hot-swap, checkpoints
def _dir_bytes(d):
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(d) for f in fs)


def _leaves_equal(torch, a, b):
    from repro_torch.checkpointing.checkpoint import flatten_tree
    from repro_torch.core.packing import PackedBCSC
    fa, fb = flatten_tree(a), flatten_tree(b)
    if set(fa) != set(fb):
        return False
    for k, x in fa.items():
        y = fb[k]
        pairs = ([(x.blocks, y.blocks), (x.idx, y.idx)]
                 if isinstance(x, PackedBCSC) else [(x, y)])
        if isinstance(x, PackedBCSC) and (x.kb, x.joint) != (y.kb, y.joint):
            return False
        for u, v in pairs:
            if u.dtype != v.dtype or not torch.equal(u, v):
                return False
    return True


def phase_artifact(torch, cfg, packed, joint):
    """Seal the packed split and joint models at full depth (bf16), then
    load each twice with the canaries replayed under the exact gates (0
    token mismatches, 0.0 logit drift: a seal and a replay on one card
    agree bitwise), the loaded leaves bitwise the sealed ones. Then each
    of the ten ``ARTIFACT_FAULTS`` on a fresh copy of a two-layer,
    full-width bf16 artifact, offered to a serving engine's
    ``swap_weights`` mid-stream: each must raise exactly its typed error,
    the generation must not flip, and the stream must finish as without
    the attempt. Returns (artifact dirs, launch counts)."""
    from repro_torch.serving import artifact
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.faults import ARTIFACT_FAULTS, FaultPlan
    os.makedirs(ART_DIR, exist_ok=True)
    emit(phase="disk", path=os.path.relpath(ART_DIR, ROOT),
         free_bytes=shutil.disk_usage(ART_DIR).free)
    dirs, counts = {}, []
    for name, params in (("split", packed), ("joint", joint)):
        d = dirs[name] = os.path.join(ART_DIR, name)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        manifest = artifact.seal(cfg, params, d)
        seal_s = time.monotonic() - t0
        t0 = time.monotonic()
        artifact.validate(d, cfg)
        validate_s = time.monotonic() - t0
        loads = []
        for _ in range(2):
            t0 = time.monotonic()
            loaded, _ = artifact.load(d, cfg, run_canaries=True,
                                      device=DEVICE)
            torch.cuda.synchronize()
            loads.append(time.monotonic() - t0)
            check(_leaves_equal(torch, loaded, params),
                  f"artifact {name}: loaded leaves differ from the sealed")
            del loaded
        c = _read_counts()
        counts.append(c)
        glu = "fused_glu_joint" if name == "joint" else "fused_glu_split"
        check(c["bspmm"] > 0 and c[glu] > 0,
              f"artifact {name}: canaries did not run the kernels: {c}")
        emit(phase="artifact", run=name, depth=cfg.num_layers,
             dtype="bfloat16", bytes_on_disk=_dir_bytes(d), seal_s=seal_s,
             validate_s=validate_s, load_canary_s=loads, canaries=len(manifest["canaries"]),
             canary_tokens=[len(x["tokens"]) for x in manifest["canaries"]],
             gates={"max_token_mismatches": 0, "max_logit_drift": 0.0},
             launches=c)
    cfg2 = dataclasses.replace(cfg, num_layers=PARITY_DEPTH)
    p2 = _first_layers(packed, PARITY_DEPTH)
    base_dir = os.path.join(ART_DIR, "two_layers")
    artifact.seal(cfg2, p2, base_dir)
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, 48).astype(np.int32)
    want = _serve(cfg2, p2, [prompt], FAULT_TOKENS)[1][0].generated
    _reset_counts()
    eng = Engine(cfg2, p2, device=DEVICE, **ENGINE)
    eng.submit(prompt, FAULT_TOKENS)
    out = {r.uid: r for r in eng.step()}
    caught = {}
    for kind in ARTIFACT_FAULTS:
        cp = os.path.join(ART_DIR, "fault_" + kind)
        shutil.copytree(base_dir, cp)
        expected = FaultPlan().on_artifact(cp, kind)
        t0 = time.monotonic()
        try:
            eng.swap_weights(cp)
            raise SmokeFailure(f"artifact fault {kind}: the swap flipped")
        except artifact.ArtifactError as e:
            check(type(e) is expected, f"artifact fault {kind}: raised "
                  f"{type(e).__name__}, expected {expected.__name__}")
            caught[kind] = {"error": type(e).__name__,
                            "seconds": time.monotonic() - t0}
        shutil.rmtree(cp)
        check(eng._gen == 0 and eng.params is p2 and eng.stats[
            "weight_swaps"] == 0, f"artifact fault {kind}: weights moved")
        out.update((r.uid, r) for r in eng.step())
    out.update(eng.run())
    c = _read_counts()
    counts.append(c)
    check(np.array_equal(out[0].generated, want),
          "artifact faults: the stream in flight changed")
    check(caught["canary_weights_signed"]["error"] == "ArtifactCanaryError"
          and eng.stats["swap_canary_failures"] == 1,
          "artifact faults: the canary replay did not catch the weights")
    shutil.rmtree(base_dir)
    emit(phase="artifact_faults", depth=PARITY_DEPTH, dtype="bfloat16",
         caught=caught, all_caught=len(caught) == len(ARTIFACT_FAULTS),
         swaps_flipped=eng.stats["weight_swaps"],
         canary_failures=eng.stats["swap_canary_failures"], launches=c)
    return dirs, counts


def _swap_traffic(torch, cfg, params, reqs, post, swap=None, poison=False,
                  monitor_steps=8, tracer=None):
    """The serving configuration on ``params`` (generation 0): ``reqs``
    ((prompt, budget) pairs) at the start, ``post`` after step
    ``SWAP_AFTER_STEP``; with ``swap`` (an artifact dir) the engine swaps
    to it just before those arrive. With ``poison`` a NaN goes into a
    generation-1 lane one step after one decodes. Records every step's
    end time, tokens, generations held and device memory, and the
    launches of every slab and prefill call by weight generation.
    Returns a dict; ``pre`` are the uids on lanes at the flip."""
    from repro_torch.serving.engine import Engine
    eng = Engine(cfg, params, device=DEVICE, tracer=tracer, **ENGINE)
    del params
    launches, slab_gens = {}, set()

    def by_gen(fn, pos):
        def call(*a, **kw):
            g = next(g for g, p in eng._gen_params.items() if p is a[pos])
            if pos == 0:
                slab_gens.add(g)
            before = _read_counts()
            fn(*a, **kw)
            tally = launches.setdefault(g, dict.fromkeys(before, 0))
            for k, v in _read_counts().items():
                tally[k] += v - before[k]
        return call

    eng._slab_call = by_gen(eng._slab_call, 0)
    eng._run_prefill = by_gen(eng._run_prefill, 3)
    uids = [eng.submit(p, n) for p, n in reqs]
    steps, out, rep, pre, poisoned = [], {}, None, None, None
    torch.cuda.synchronize()
    t_prev = time.monotonic()
    while (len(eng.scheduler) or eng.active_lanes or eng._pending_results
           or len(steps) <= SWAP_AFTER_STEP):
        n = len(steps)
        if n == SWAP_AFTER_STEP:
            pre = sorted(eng.lanes[i].req.uid for i in eng.active_lanes)
            if swap is not None:
                c0 = _read_counts()
                rep = eng.swap_weights(swap, monitor_steps=monitor_steps)
                launches["canary"] = {k: v - c0[k]
                                      for k, v in _read_counts().items()}
            uids += [eng.submit(p, b) for p, b in post]
        if poison and poisoned is None and n > SWAP_AFTER_STEP:
            g1 = [i for i in eng.active_lanes if eng.lanes[i].gen == 1
                  and eng._mirror["live"][i]]
            if g1:
                eng._mirror["poison"][g1[0]] = np.nan
                eng._dirty = True
                poisoned = eng.lanes[g1[0]].req.uid
        slab_gens.clear()
        out.update((r.uid, r) for r in eng.step())
        t = time.monotonic()
        steps.append({"t": t, "gap": t - t_prev,
                      "tokens": eng.stats["generated_tokens"],
                      "held": len(eng._gen_params),
                      "monitor": eng._swap_monitor is not None,
                      "slab_gens": sorted(slab_gens),
                      "mem": torch.cuda.memory_allocated()})
        t_prev = t
        check(len(steps) < 2000, "swap traffic did not drain")
    eng.finalize_stats()
    return {"steps": steps, "out": out, "uids": uids, "pre": pre,
            "gen": {u: out[u].generated for u in uids if out[u].ok},
            "report": rep, "launches": launches, "stats": dict(eng.stats),
            "poisoned": poisoned}


def _held_sequence(steps):
    held = [s["held"] for s in steps]
    return [h for i, h in enumerate(held) if i == 0 or h != held[i - 1]]


def phase_serve_swap(torch, cfg, dirs, prompts, rng):
    """Zero-downtime hot-swap at full depth in bf16: generation 0 is the
    split-mask model loaded from its artifact, generation 1 the sealed
    joint-mask model. The 12 serving prompts (budgets of 16 to 64 tokens,
    so lanes free at different steps), ``swap_weights`` after step 2, 4
    more requests after it. Held: the streams of lanes admitted before
    the flip equal a run without the swap bitwise; the later ones equal
    a fresh engine on generation 1's weights under the same traffic (a
    divergence only at a near-tie, as ``phase_parity``); the split GLU
    launches only in generation-0 calls and the joint GLU only in
    generation-1 calls, both inside the window, where some step decodes
    both; generations held go 1, 2, 1 and generation 0's device memory
    is released when its last lane retires. Then the same swap behind
    ``AsyncEngine`` while traffic flows, and a run whose generation-1
    lane turns NaN inside the window, which must roll back with the
    generation-0 streams untouched. Returns the launch counts."""
    import asyncio
    import gc
    from repro_torch.serving import artifact, hotswap
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.frontend import AsyncEngine
    # budgets of 16, 32, 48, 64 in turn: lanes free at different steps,
    # so new-generation lanes admit while old ones still decode
    reqs = [(p, NEW_TOKENS * (1 + i % 4) // 4)
            for i, p in enumerate(prompts)]
    post = [(rng.integers(0, cfg.vocab_size, size=(int(n),))
             .astype(np.int32), NEW_TOKENS)
            for n in rng.integers(32, 129, size=SWAP_POST)]
    everything = [p for p, _ in reqs + post]
    counts = []

    def gen0():
        return artifact.load(dirs["split"], cfg, device=DEVICE)[0]

    _reset_counts()
    base = _swap_traffic(torch, cfg, gen0(), reqs, post)
    gen1 = artifact.load(dirs["joint"], cfg, device=DEVICE)[0]
    fresh = _swap_traffic(torch, cfg, gen1, reqs, post)
    counts.append(_read_counts())
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    run = _swap_traffic(torch, cfg, gen0(), reqs, post, swap=dirs["joint"])
    peak = torch.cuda.max_memory_allocated()
    counts.append(_read_counts())
    rep, steps, pre = run["report"], run["steps"], run["pre"]
    later = [u for u in run["uids"] if u not in pre]
    check(rep.state == hotswap.COMMITTED, f"swap ended {rep.state}")
    check(sorted(run["gen"]) == sorted(run["uids"]),
          "swap: a request did not complete")
    check(all(np.array_equal(run["gen"][u], base["gen"][u]) for u in pre),
          "swap: a stream admitted before the flip changed")
    accepted = _near_tie_equal(torch, cfg, gen1, everything,
                               {u: run["gen"][u] for u in later},
                               {u: fresh["gen"][u] for u in later},
                               "serve_swap")
    l0, l1 = run["launches"][0], run["launches"][1]
    check(l0["fused_glu_split"] > 0 and l0["fused_glu_joint"] == 0,
          f"swap: generation-0 calls launched {l0}")
    check(l1["fused_glu_joint"] > 0 and l1["fused_glu_split"] == 0,
          f"swap: generation-1 calls launched {l1}")
    seq = _held_sequence(steps)
    check(seq == [1, 2, 1], f"swap: generations held went {seq}")
    window = [i for i, s in enumerate(steps) if s["held"] == 2]
    both = [i for i in window if steps[i]["slab_gens"] == [0, 1]]
    check(both, "swap: no step decoded both generations")
    w0, w1 = window[0], window[-1]
    mem_before = steps[w0 - 1]["mem"]
    # generation 0's params go when its last lane retired and the monitor
    # (which keeps them for a rollback) committed
    freed = [i for i in range(w1 + 1, len(steps))
             if not steps[i]["monitor"]]
    check(freed, "swap: the monitor window outlived the traffic")
    mem_after = steps[freed[0]]["mem"]
    gen_bytes = _dir_bytes(dirs["split"])
    check(mem_after < peak - 0.5 * gen_bytes,
          f"swap: device memory {mem_after} did not drop from the peak "
          f"{peak} after generation 0 retired")
    # decode rate inside the window, after the step that carried the swap
    t_win = steps[w1]["t"] - steps[w0]["t"]
    tok_win = steps[w1]["tokens"] - steps[w0]["tokens"]
    bs = base["steps"]
    b_win = bs[w1]["t"] - bs[w0]["t"]
    b_tok = bs[w1]["tokens"] - bs[w0]["tokens"]
    gaps = [s["gap"] for s in steps[1:]]
    emit(phase="serve_swap", run="sync", depth=cfg.num_layers,
         dtype="bfloat16", requests=len(reqs), post_flip_submitted=len(post),
         swap_after_step=SWAP_AFTER_STEP, state=rep.state,
         stage_s=rep.stage_s, canary_s=rep.canary_s, flip_s=rep.flip_s,
         canary_tokens=run["stats"]["swap_canary_tokens"],
         pause_s=steps[SWAP_AFTER_STEP]["gap"], max_gap_s=max(gaps),
         median_gap_s=statistics.median(gaps),
         window_steps=len(window), steps_decoding_both=len(both),
         window_tok_per_s=tok_win / t_win,
         no_swap_tok_per_s_same_steps=b_tok / b_win,
         tok_per_s=run["stats"]["tok_per_s"],
         no_swap_tok_per_s=base["stats"]["tok_per_s"],
         generations_held=seq, pre_flip_bitwise=len(pre),
         post_flip_requests=len(later),
         post_flip_accepted_divergences=accepted,
         generation_bytes_on_disk=gen_bytes,
         mem_before_swap_bytes=mem_before,
         peak_mem_both_generations_bytes=peak,
         mem_after_retire_bytes=mem_after,
         launches_by_generation={str(k): v for k, v in
                                 run["launches"].items()})
    del gen1

    # behind the asyncio front door, swapping while traffic flows
    _reset_counts()
    eng = Engine(cfg, gen0(), device=DEVICE, **ENGINE)

    async def drive():
        async with AsyncEngine(eng) as front:
            streams = [await front.submit_async(p, n) for p, n in reqs]
            await streams[0].__anext__()
            t0 = time.monotonic()
            r = await front.swap_weights_async(dirs["joint"],
                                               monitor_steps=8)
            swap_wall = time.monotonic() - t0
            streams += [await front.submit_async(p, n) for p, n in post]
            return r, swap_wall, [await s.result() for s in streams]

    arep, swap_wall, res = asyncio.run(asyncio.wait_for(drive(), 600))
    c = _read_counts()
    counts.append(c)
    check(all(r.ok for r in res), "async swap: a request failed")
    check(arep.state in (hotswap.FLIPPED, hotswap.COMMITTED)
          and eng.stats["weight_swaps"] == 1 and len(eng._gen_params) == 1,
          f"async swap: {arep.state}, held {len(eng._gen_params)}")
    check(c["fused_glu_split"] > 0 and c["fused_glu_joint"] > 0,
          f"async swap: launches {c}")
    emit(phase="serve_swap", run="async", state=arep.state,
         stage_s=arep.stage_s, canary_s=arep.canary_s, flip_s=arep.flip_s,
         swap_wall_s=swap_wall, completed=len(res),
         tok_per_s=eng.stats["tok_per_s"], launches=c)
    del eng

    # a NaN in a generation-1 lane inside the window rolls back
    from repro_torch.obs.trace import Tracer
    pm_dir = os.path.join(OBS_DIR, "swap_rollback")
    shutil.rmtree(pm_dir, ignore_errors=True)
    tr = Tracer(postmortem_dir=pm_dir)
    _reset_counts()
    rb = _swap_traffic(torch, cfg, gen0(), reqs, post, swap=dirs["joint"],
                       poison=True, monitor_steps=1000, tracer=tr)
    counts.append(_read_counts())
    rrep = rb["report"]
    check(rrep.state == hotswap.ROLLED_BACK
          and rrep.rollback_reason == "quarantine_spike",
          f"rollback run ended {rrep.state}")
    bad = rb["out"][rb["poisoned"]]
    check(type(bad.error).__name__ == "LaneFaultError",
          f"rollback: the poisoned request ended {bad.error!r}")
    check(rb["pre"] == pre and all(
        np.array_equal(rb["gen"][u], base["gen"][u]) for u in pre),
        "rollback: a generation-0 stream changed")
    check(sorted(rb["gen"]) == sorted(u for u in rb["uids"]
                                      if u != rb["poisoned"]),
          "rollback: another request failed")
    emit(phase="serve_swap", run="rollback", state=rrep.state,
         rollback_reason=rrep.rollback_reason,
         rollback_gen=rrep.rollback_gen, quarantines=rrep.quarantines,
         poisoned_uid=rb["poisoned"], pre_flip_bitwise=len(pre),
         generations_held=_held_sequence(rb["steps"]),
         swap_rollbacks=rb["stats"]["swap_rollbacks"],
         launches_by_generation={str(k): v for k, v in
                                 rb["launches"].items()})
    reasons = [p["reason"] for p in tr.postmortems]
    check(reasons == ["swap.rollback"],
          f"obs_postmortems swap: reasons {reasons}")
    pm = tr.postmortems[0]
    check(pm["meta"]["cause"] == "quarantine_spike"
          and _uid_in(pm["spans"], rb["poisoned"]),
          f"obs_postmortems swap: {pm['meta']}, victim {rb['poisoned']}")
    stages = [s.name for s in tr.records if s.name.startswith("swap.")]
    check(stages == ["swap.stage", "swap.canary", "swap.flip",
                     "swap.rollback"], f"obs swap spans {stages}")
    emit(phase="obs_postmortems", drive="serve_swap_rollback",
         victim=rb["poisoned"], postmortems=_postmortem_rows(tr, pm_dir),
         swap_spans_ms={s.name: s.dur * 1e3 for s in tr.records
                        if s.name.startswith("swap.")})
    return counts


# ------------------------------------------- tensor-parallel serving
def _tp_rank(rank, world, backend, cfg, dirs, prompts, loop_prompts):
    """One rank of ``serve_tp`` (a spawned process): start the group from
    the ``file://`` store in ``TP_DIR``, load the sealed split artifact
    and keep this rank's shard, serve the 12 requests through the TP
    engine (phased, then mixed) and the 4 oracle prompts through
    ``serve_loop.generate``, gather the full-depth next-token logits of 4
    prompts, then serve 4 requests of the joint artifact; launch counts
    reset before and read after each run. Pickles what it saw to
    ``rank<r>.pkl`` in ``TP_DIR``."""
    import pickle
    _die_with_parent()

    import torch
    import torch.distributed as tdist
    from repro_torch.distributed.context import (DistContext,
                                                 init_process_group,
                                                 make_mesh)
    from repro_torch.serving import artifact, export, serve_loop
    from repro_torch.serving.engine import Engine
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    init_process_group(TP_DIR, rank, world, backend)
    try:
        mesh = make_mesh((1, world), ("data", "model"))
        dist = DistContext(mesh)
        out = {"rank": rank, "device": torch.cuda.current_device()}

        def shard(name):
            full, _ = artifact.load(dirs[name], cfg, device=DEVICE)
            local = export.shard_params(cfg, full, mesh)
            del full
            torch.cuda.empty_cache()
            return local

        params = shard("split")
        out["weight_bytes"] = export.memory_report(cfg, params)["bytes"]
        runs = {}
        for name, mode in (("phased", {}), ("mixed", {"mixed": True})):
            _reset_counts()
            eng = Engine(cfg, params, device=DEVICE, dist=dist, **ENGINE,
                         **mode)
            uids = [eng.submit(p, NEW_TOKENS) for p in prompts]
            t0 = time.monotonic()
            res = eng.run()
            wall = time.monotonic() - t0
            runs[name] = dict(
                streams=[res[u].generated for u in uids],
                ok=all(res[u].ok for u in uids), wall_s=wall,
                digest=eng.lockstep_digest, launches=_read_counts(),
                kv_pool_bytes=sum(t.numel() * t.element_size()
                                  for t in eng.cache.values()),
                **{k: eng.stats[k] for k in (
                    "tok_per_s", "ttft_p50_s", "stalled_decode_steps",
                    "mixed_steps", "decode_slabs", "prefill_chunks")})
            del eng
        _reset_counts()
        toks, st = serve_loop.generate(
            cfg, params, np.stack(loop_prompts), max_new_tokens=LOOP_TOKENS,
            device=DEVICE, dist=dist)
        runs["serve_loop"] = dict(streams=toks[:, LOOP_LEN:],
                                  launches=_read_counts(),
                                  tok_per_s=st["tok_per_s"])
        out["logits"] = [_last_logits(torch, cfg, params, p, dist)
                         .cpu().numpy() for p in prompts[:4]]
        out["sp_prefill"] = _sp_prefill(torch, tdist, cfg, params, dist)
        del params
        params = shard("joint")
        _reset_counts()
        eng = Engine(cfg, params, device=DEVICE, dist=dist, **ENGINE)
        uids = [eng.submit(p, 16) for p in prompts[:4]]
        res = eng.run()
        runs["joint"] = dict(streams=[res[u].generated for u in uids],
                             digest=eng.lockstep_digest,
                             launches=_read_counts(),
                             tok_per_s=eng.stats["tok_per_s"])
        out["runs"] = runs
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    finally:
        tdist.destroy_process_group()
    with open(os.path.join(TP_DIR, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _sp_prefill_tokens(torch, cfg):
    """``SP_PREFILL`` seeded prompts of ``SP_PREFILL_LEN`` tokens, on the
    card."""
    rng = np.random.default_rng(SEED + 27)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(
        SP_PREFILL, SP_PREFILL_LEN)).astype(np.int32), device=DEVICE)


def _sp_prefill(torch, tdist, cfg, params, dist):
    """``serving/step.py::make_prefill_step`` with ``dist=`` (sequence
    parallelism on, the reference's default) over this rank's packed
    shard on ``_sp_prefill_tokens``: the gathered last-token logits, the
    collectives by kind (counted from here on in this rank), the kernel
    launches and the seconds of the call."""
    from repro_torch.serving.step import make_prefill_step
    counts = _count_collectives(tdist)
    tokens = _sp_prefill_tokens(torch, cfg)
    torch.cuda.synchronize()
    _reset_counts()
    counts.clear()
    t0 = time.monotonic()
    with torch.inference_mode():
        last = make_prefill_step(cfg, dist)(params, tokens)
    torch.cuda.synchronize()
    return dict(logits=last.float().cpu().numpy(),
                wall_s=time.monotonic() - t0,
                seq_split=dist.seq_split(tuple(tokens.shape)
                                         + (cfg.d_model,)),
                collectives={k: dict(v) for k, v in counts.items()},
                launches=_read_counts())


def _die_with_parent():
    """Have the kernel SIGKILL this spawned rank when the script's
    process ends, however it ends, so no rank outlives a killed run."""
    import ctypes
    import multiprocessing
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PDEATHSIG
    if os.getppid() != multiprocessing.parent_process().pid:
        os._exit(1)


@contextlib.contextmanager
def _killed_on_failure(procs):
    """Kill ``procs`` (spawned ranks) if the block raises."""
    try:
        yield
    except BaseException:
        for p in procs:
            p.kill()
        raise


def _start_ranks(directory, target, world, args):
    """Start ``world`` spawned processes ``target(rank, *args)`` with a
    fresh ``directory`` (their gloo store and results); returns them.
    They are daemons: the script's exit ends any that still run."""
    import multiprocessing
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join_ranks(name, directory, procs):
    """Wait for ``_start_ranks``' processes; a rank that fails or
    overruns fails the phase (the others are killed). Returns each rank's
    pickled ``rank<r>.pkl``, in rank order."""
    import pickle
    deadline = time.monotonic() + TP_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
            # one rank failing leaves the others blocked in a collective
            if p.exitcode not in (None, 0):
                break
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    check(codes == [0] * len(procs), f"{name}: rank exit codes {codes}")
    out = []
    for r in range(len(procs)):
        with open(os.path.join(directory, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    shutil.rmtree(directory)
    return out


def _tp_kernel_lines(torch, card, cfg, packed, joint, world):
    """Each kernel of the path at rank 1's tp-``world`` shapes (rank 1
    holds the down pack's zero padding): ``bspmm`` on its local down pack
    over the all-gathered (8, d_ff) rows, both GLUs on its local gate/up
    columns at M = 8, paged decode on its local heads at B = 8 over R =
    16, each held against its plain version within ``ulp_tol`` and timed
    beside its bound and library call (``_mlp_lines``, ``_paged_line``)."""
    from repro_torch.distributed.context import DistContext, Mesh
    from repro_torch.models import attention
    from repro_torch.serving import export
    mesh = Mesh(("data", "model"), (1, world), 1)
    local = export.shard_params(cfg, _first_layers(packed, 1), mesh)
    jlocal = export.shard_params(cfg, _first_layers(joint, 1), mesh)
    mlp0 = _mlp_of(cfg, local, 0)
    jmlp0 = _mlp_of(cfg, jlocal, 0)
    timer = Timer(torch)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    base = dict(tp=world, rank=1, block=[cfg.blast.b_in, cfg.blast.b_out])
    out = _mlp_lines(torch, card, timer, gen, "tp_kernel", (), ARCH_M,
                     mlp0["w_down"], mlp0["w_gate"], mlp0["w_up"],
                     jmlp0["w_gate"], jmlp0["w_up"], cfg.mlp_act,
                     down_partial=mlp0["w_down"].partial, **base)
    _, hl, _, kvl = attention.local_heads(cfg, DistContext(mesh))
    out["paged_flash_decode"] = _paged_line(
        torch, card, timer, gen, "tp_kernel", kvl, hl // kvl, cfg.head_dim,
        cfg.attn_scale, float(cfg.attn_logit_softcap or 0.0),
        cfg.sliding_window, **base)
    return out


def _serve_tp_start(torch, cfg, dirs, prompts, loop_prompts):
    """Spawn ``serve_tp``'s ``TP_SIZE`` ranks (``_tp_rank``): NCCL with a
    card each, else gloo sharing card 0. They serve on their own, compared
    with the single-device runs only when ``phase_serve_tp`` joins them,
    so they run beside ``serve_swap``. -> (processes, backend)."""
    world = TP_SIZE
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    torch.cuda.synchronize()
    return (_start_ranks(TP_DIR, _tp_rank, world,
                         (world, backend, cfg, dirs, prompts, loop_prompts)),
            backend)


def phase_serve_tp(torch, card, cfg, packed, joint, prompts, loop_prompts,
                   single, started):
    """Llama-3.2-1B served tensor-parallel at full width and depth over a
    model axis of ``TP_SIZE`` ranks (``dist=``): each rank a spawned
    process that loads the sealed split artifact (the weights the
    single-device phases served, bitwise) and keeps its shard
    (``export.shard_params``). With two or more cards each rank takes its
    own over NCCL; with one, both share card 0 over gloo (NCCL refuses
    two ranks on one device), whose collectives carry CUDA tensors, so
    this measures no tensor-parallel speed and claims none.

    Holds, per rank: the 12 requests' streams through the TP engine,
    phased and mixed, and the 4 oracle prompts' through
    ``serve_loop.generate``, equal to the single-device runs' (a first
    divergence only where the single-device margin is below
    ``TP_NEAR_TIE`` logits tolerances); every rank's streams and
    block-table/page digests equal, and the digests equal to the
    single-device engines'; the full-depth next-token logits of 4 prompts
    within 2**-5 of their magnitude; the split GLU, ``bspmm`` and paged
    decode launched on every rank (and the joint GLU in a short run of
    the joint artifact); each rank's weight bytes at most
    ``TP_BYTES_FRACTION`` of the single-device packed bytes plus the
    leaves every rank holds whole, and its KV pool 1/``TP_SIZE`` of the
    single-device pool. Then the kernels at a rank's local shapes
    (``tp_kernel`` lines). ``started`` is ``_serve_tp_start``'s (the
    ranks ran beside ``serve_swap``). Returns the ranks' launch counts."""
    from repro_torch.distributed.context import Mesh
    from repro_torch.models import attention
    from repro_torch.serving import export
    procs, backend = started
    world = len(procs)
    ranks = _join_ranks("serve_tp", TP_DIR, procs)
    # the single-device figures
    full_bytes = export.memory_report(cfg, packed)["bytes"]
    whole = _whole_bytes(cfg, packed, Mesh(("data", "model"), (1, world), 0))
    ps = ENGINE["page_size"]
    n_pages = ENGINE["max_batch"] * -(-ENGINE["max_len"] // ps)
    _, kv = attention.eff_heads(cfg)
    single_pool = 2 * cfg.num_layers * n_pages * ps * kv * cfg.head_dim * 2
    single_logits = [_last_logits(torch, cfg, packed, p) for p in prompts[:4]]
    mag = max(float(x.abs().max()) for x in single_logits)
    tol = 2.0 ** -5 * mag
    err = max(float(np.abs(r["logits"][i] - single_logits[i].cpu().numpy())
                    .max()) for r in ranks for i in range(4))
    check(err <= tol, f"serve_tp: full-depth logits differ by {err} > {tol}")
    near_tie = TP_NEAR_TIE * tol
    want = {name: [r.generated for r in single[name][0]]
            for name in ("phased", "mixed", "joint")}
    want["serve_loop"] = list(single["serve_loop"])
    accepted, counts = {}, []
    r0 = ranks[0]["runs"]
    for name in ("phased", "mixed", "serve_loop", "joint"):
        accepted[name] = _near_tie_equal(
            torch, cfg, joint if name == "joint" else packed,
            loop_prompts if name == "serve_loop" else prompts,
            dict(enumerate(r0[name]["streams"])), dict(enumerate(want[name])),
            f"serve_tp {name}", tol=near_tie)
    for r in ranks:
        runs = r["runs"]
        for name in ("phased", "mixed", "serve_loop", "joint"):
            for a, b in zip(runs[name]["streams"], r0[name]["streams"]):
                check(np.array_equal(a, b),
                      f"serve_tp {name}: rank {r['rank']}'s streams differ "
                      "from rank 0's")
            counts.append(runs[name]["launches"])
        for name in ("phased", "mixed", "joint"):
            check(runs[name]["digest"]
                  == single[name][1]["lockstep_digest"],
                  f"serve_tp {name}: rank {r['rank']}'s block tables and "
                  "page accounting differ from the single-device run's")
        for name in ("phased", "mixed"):
            check(runs[name]["ok"], f"serve_tp {name}: a request failed")
            check(runs[name]["kv_pool_bytes"] * world == single_pool,
                  f"serve_tp {name}: rank {r['rank']} KV pool "
                  f"{runs[name]['kv_pool_bytes']} bytes")
            for k in PAGED:
                check(runs[name]["launches"][k] > 0,
                      f"serve_tp {name}: rank {r['rank']} never launched {k}")
        check(runs["mixed"]["stalled_decode_steps"] == 0,
              "serve_tp mixed: decode stalled")
        check(runs["joint"]["launches"]["fused_glu_joint"] > 0
              and runs["joint"]["launches"]["fused_glu_split"] == 0,
              f"serve_tp joint: rank {r['rank']} launches "
              f"{runs['joint']['launches']}")
        check(runs["serve_loop"]["launches"]["bspmm"] > 0
              and runs["serve_loop"]["launches"]["fused_glu_split"] > 0,
              "serve_tp serve_loop launched no BSpMM kernel")
        check(r["weight_bytes"] <= TP_BYTES_FRACTION * full_bytes + whole,
              f"serve_tp: rank {r['rank']} holds {r['weight_bytes']} bytes "
              f"of {full_bytes} ({whole} held whole)")
    sp = _check_sp_prefill(torch, cfg, packed, ranks)
    counts += [r["sp_prefill"]["launches"] for r in ranks]
    lines = _tp_kernel_lines(torch, card, cfg, packed, joint, world)
    emit(phase="serve_tp", model=cfg.name, depth=cfg.num_layers, tp=world,
         backend=backend, devices=[r["device"] for r in ranks],
         collectives="native (torch.distributed over the backend; gloo "
                     "stages CUDA tensors through host memory itself)",
         requests=len(prompts), new_tokens=NEW_TOKENS,
         loop_prompts=len(loop_prompts), loop_tokens=LOOP_TOKENS,
         streams_equal_single_device=True, accepted_divergences=accepted,
         near_tie=near_tie, logits_max_abs_err=err, logits_tol=tol,
         logits_err_over_tol=err / tol,
         digests_equal_single_device=True,
         weight_bytes_per_rank=[r["weight_bytes"] for r in ranks],
         single_device_weight_bytes=full_bytes, whole_leaf_bytes=whole,
         kv_pool_bytes_per_rank=[r["runs"]["phased"]["kv_pool_bytes"]
                                 for r in ranks],
         single_device_kv_pool_bytes=single_pool,
         peak_bytes_per_rank=[r["peak_bytes"] for r in ranks],
         runs={name: [{k: v for k, v in r["runs"][name].items()
                       if k not in ("streams",)} for r in ranks]
               for name in ("phased", "mixed", "serve_loop", "joint")},
         kernel_lines={k: {"ms": v["ms"], "max_abs_err": v["max_abs_err"]}
                       for k, v in lines.items()},
         sp_prefill=sp,
         tok_per_s_note="two ranks on one card over gloo: the phase's "
                        "own rate, not a tensor-parallel speed")
    return counts


def _check_sp_prefill(torch, cfg, packed, ranks) -> dict:
    """The ranks' sequence-parallel ``make_prefill_step`` (``_sp_prefill``)
    against one device's on the same packed weights and tokens: on every
    rank the stream split along S, reduce-scatters issued, the split GLU
    and ``bspmm`` launched, the last-token logits within ``serve_tp``'s
    bound (2**-5 of the one-device logits' magnitude) and the greedy
    tokens equal but where one device's top-2 margin is below
    ``TP_NEAR_TIE`` times that bound. Returns the line's readings."""
    from repro_torch.serving.step import make_prefill_step
    tokens = _sp_prefill_tokens(torch, cfg)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.inference_mode():
        single = make_prefill_step(cfg)(packed, tokens).float()
    torch.cuda.synchronize()
    single_s = time.monotonic() - t0
    top2 = torch.topk(single, 2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    want = single.argmax(-1).cpu().numpy()
    single = single.cpu().numpy()
    tol = 2.0 ** -5 * float(np.abs(single).max())
    near_tie = TP_NEAR_TIE * tol
    err, accepted = 0.0, []
    for r in ranks:
        p = r["sp_prefill"]
        at = f"serve_tp sp prefill: rank {r['rank']}"
        check(p["seq_split"], f"{at}: the stream was not split along S")
        rs = sum(p["collectives"].get("reduce_scatter", {}).values())
        check(rs > 0, f"{at}: no reduce-scatter ({p['collectives']})")
        check(p["launches"]["bspmm"] > 0
              and p["launches"]["fused_glu_split"] > 0,
              f"{at}: launches {p['launches']}")
        check(p["logits"].shape == single.shape,
              f"{at}: logits {p['logits'].shape}")
        err = max(err, float(np.abs(p["logits"] - single).max()))
        got = p["logits"].argmax(-1)
        for row in np.nonzero(got != want)[0]:
            check(margin[row] < near_tie,
                  f"{at}: row {row} greedy {got[row]} != {want[row]} at "
                  f"margin {margin[row]} (near-tie {near_tie})")
            accepted.append((r["rank"], int(row), float(margin[row])))
    check(err <= tol, f"serve_tp sp prefill: logits differ by {err} > {tol}")
    r0 = ranks[0]["sp_prefill"]
    return dict(prompts=SP_PREFILL, tokens=SP_PREFILL_LEN,
                seq_split=r0["seq_split"], logits_max_abs_err=err,
                logits_tol=tol, logits_err_over_tol=err / tol,
                near_tie=near_tie, accepted_divergences=accepted,
                greedy_equal_rows=int(sum(
                    (r["sp_prefill"]["logits"].argmax(-1) == want).sum()
                    for r in ranks)),
                collectives_per_rank=[r["sp_prefill"]["collectives"]
                                      for r in ranks],
                launches_per_rank=[r["sp_prefill"]["launches"]
                                   for r in ranks],
                wall_s_per_rank=[r["sp_prefill"]["wall_s"] for r in ranks],
                single_device_s=single_s)


def _train_tp_warm(torch, cfg, opt, src, dist, dp):
    """The paths of ``train_tp`` on a small model (4 layers, width 256,
    vocabulary 2048: a few MB): two sharded steps (the first refreshes)
    and one deferred int8 step, so the CUDA kernels, cuBLAS and the gloo
    connections are loaded before the measured run, beside the chaos
    chain."""
    from repro_torch.distributed import sharding
    from repro_torch.training import deferred, step as ts
    wcfg = dataclasses.replace(cfg, num_layers=4, d_model=256, num_heads=4,
                               num_kv_heads=2, head_dim=64, d_ff=1024,
                               vocab_size=2048)
    batch = {k: torch.as_tensor(v % wcfg.vocab_size, device=DEVICE)
             for k, v in src.batch(0).items()}
    st = ts.init_state(wcfg, SEED, DEVICE, dist=dist)
    step = ts.make_train_step(wcfg, opt, dist=dist)
    for _ in range(2):
        st, _ = step(st, batch)
    st = ts.init_state(wcfg, SEED, DEVICE, dist=dp)
    st.opt_state = deferred.init_opt_state(wcfg, st.params, True)
    deferred.make_train_step_deferred(wcfg, opt, dp, microbatches=2)(
        st, sharding.slice_batch(batch, dp))
    del st
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _count_collectives(tdist) -> dict:
    """Count every all-reduce, all-gather and reduce-scatter this process
    issues from now on: ``torch.distributed``'s functions wrapped, each
    call noted under its kind by the bytes this rank puts in (the tensor
    reduced, its part of the gather, or the whole tensor it
    reduce-scatters: ``reduce_scatter_tensor``, ``reduce_scatter_single``
    from torch 2.13, which gloo takes on CUDA tensors too). Returns the
    counts, {kind: {bytes: calls}}, which the caller clears."""
    stats = {}

    def wrap(kind, fn, part):
        def call(*a, **kw):
            x = part(*a)
            per = stats.setdefault(kind, {})
            n = x.numel() * x.element_size()
            per[n] = per.get(n, 0) + 1
            return fn(*a, **kw)
        return call

    tdist.all_reduce = wrap("all_reduce", tdist.all_reduce, lambda t, *_: t)
    tdist.all_gather = wrap("all_gather", tdist.all_gather,
                            lambda parts, t, *_: t)
    for name in ("reduce_scatter_tensor", "reduce_scatter_single"):
        if hasattr(tdist, name):
            setattr(tdist, name, wrap("reduce_scatter", getattr(tdist, name),
                                      lambda out, t, *_: t))
    return stats


def _train_tp_rank(rank, world, backend, cfg, opt, src, go):
    """One rank of ``train_tp`` (a spawned process): one group, a (data 1,
    model 2) mesh for (a) and a (data 2, model 1) mesh for (b). It starts
    beside the chaos chain, warms up (``_train_tp_warm``) and waits for
    ``go`` (set once the chain is done), then runs (a) and (b). (a):
    ``train_loop.train(dist=)`` from the seeded init, the train phase's
    config, ``TRAIN_TP_STEPS`` steps; per step the collectives (calls and
    bytes by kind) of the step itself, this rank's ``_grad_history`` and
    the gathered masks after each refresh. (b): ``TRAIN_DP_STEPS``
    deferred int8 steps from step ``TRAIN_DP_START``; before each, the
    local gradients, each leaf's error feedback added, reduced both ways
    (int8 and f32, timed), then the step, and its new params and masks
    against the one-device refresh and AdamW update applied to the
    compressed mean; on data rank 0 the one-device loss of the whole
    batch. Between (a) and (b) the sharded KD steps (``_kd_state``,
    ``_kd_steps``). Pickles what it saw to ``rank<r>.pkl`` in
    ``TRAIN_TP_DIR``."""
    import pickle
    _die_with_parent()

    import torch
    import torch.distributed as tdist
    from repro_torch.checkpointing.checkpoint import flatten_tree
    from repro_torch.core import sparse_mlp as sm
    from repro_torch.distributed import sharding
    from repro_torch.distributed.context import (DistContext,
                                                 init_process_group,
                                                 make_mesh)
    from repro_torch.models import registry
    from repro_torch.optim import adamw, compress
    from repro_torch.training import deferred, step as ts, train_loop
    # the ranks warm up beside the chaos chain, the group's critical
    # path: leave the host's cores to it first
    os.nice(10)
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    init_process_group(TRAIN_TP_DIR, rank, world, backend)
    try:
        dist = DistContext(make_mesh((1, world), ("data", "model")))
        dp = DistContext(make_mesh((world, 1), ("data", "model")))
        out = {"rank": rank, "device": torch.cuda.current_device()}
        t0 = time.monotonic()
        _train_tp_warm(torch, cfg, opt, src, dist, dp)
        out["warm_s"] = time.monotonic() - t0
        go.wait()
        counts = _count_collectives(tdist)

        # (a) the model axis
        seen, stats, history, make = [], [], [], ts.make_train_step

        def recording(*a, **kw):
            fn = make(*a, **kw)

            def step(state, batch):
                counts.clear()
                new, m = fn(state, batch)
                stats.append({k: dict(v) for k, v in counts.items()})
                seen.append((state.step, new.masks))
                history.append({p: x.cpu().numpy() for p, x in
                                _grad_history(torch,
                                              new.opt_state["v"]).items()})
                return new, m
            return step

        train_loop.step_mod.make_train_step = recording
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        try:
            state, hist = train_loop.train(
                cfg, opt, src, train_loop.TrainLoopConfig(
                    total_steps=TRAIN_TP_STEPS, log_every=1),
                device=DEVICE, seed=SEED, dist=dist, log_fn=lambda e: None)
        finally:
            train_loop.step_mod.make_train_step = make
        torch.cuda.synchronize()
        steps = [h for h in hist if "event" not in h]
        shd = sharding.state_shardings(cfg, dist.mesh)
        out["a"] = dict(
            wall_s=time.monotonic() - t0,
            losses=[h["loss"] for h in steps],
            grad_norms=[h["grad_norm"] for h in steps],
            anomalies=sum(int(h["anomaly"]) for h in steps),
            sec_per_step=[h["sec_per_step"] for h in steps],
            collectives=stats, history=history,
            split=flatten_tree(sharding.shard_flags(shd.params)),
            masks={st: {p: m.cpu().numpy() for p, m in sharding.gather_tree(
                masks, shd.masks).items()}
                for st, masks in seen if st % TRAIN_STEP_SIZE == 0},
            param_bytes=sharding.count_bytes(state.params),
            state_bytes=sharding.count_bytes(
                {"params": state.params, "opt": state.opt_state}),
            peak_bytes=torch.cuda.max_memory_allocated())
        out["a"]["sp"] = dict(on=dist.sp, seq_split=dist.seq_split(
            (TRAIN_BATCH, TRAIN_SEQ, cfg.d_model)))
        del state, seen
        torch.cuda.empty_cache()

        # distillation on the model axis, sequence-parallel: the teacher
        # sharded like the student, its forward in the step
        t0 = time.monotonic()
        torch.cuda.reset_peak_memory_stats()
        kst, teacher = _kd_state(torch, cfg, dist)
        kstep = ts.make_train_step(
            cfg, opt, dist=dist, kd_beta=KD_BETA, teacher_cfg=cfg,
            teacher_params_static=teacher, kd_temperature=KD_TEMPERATURE)
        out["kd"] = _kd_steps(torch, src, kst, kstep, counts, dist)
        whole = sharding.gather_tree(out["kd"].pop("last_masks"), shd.masks)
        out["kd"].update(
            wall_s=time.monotonic() - t0,
            teacher_bytes=sharding.count_bytes(teacher),
            peak_bytes=torch.cuda.max_memory_allocated(),
            masks={p: m.cpu() for p, m in whole.items()})
        del kst, teacher, kstep, whole
        torch.cuda.empty_cache()

        # (b) the data axis: deferred, int8, two microbatches
        cfg4 = dataclasses.replace(cfg, num_layers=TRAIN_DP_LAYERS)
        spec, flags = cfg4.blast, registry.dense_layer_flags(cfg4)
        flags = flags.to(DEVICE) if flags is not None else None
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        st = ts.init_state(cfg4, SEED, DEVICE, dist=dp)
        st.opt_state = deferred.init_opt_state(cfg4, st.params, True)
        st.step = TRAIN_DP_START
        full = {k: torch.as_tensor(v, device=DEVICE)
                for k, v in src.batch(0).items()}
        b = sharding.slice_batch(full, dp)
        one = None
        if dp.data_rank == 0:
            with torch.no_grad():
                one = float(ts.loss_fn(cfg4, st.params, st.masks, full)[0])
        # the second step distills from the 4-layer dense seeded init
        teacher4 = registry.init_params(cfg4, SEED, DEVICE)
        kd4 = dict(kd_beta=KD_BETA, teacher_cfg=cfg4,
                   kd_temperature=KD_TEMPERATURE)
        csteps = [deferred.make_train_step_deferred(
            cfg4, opt, dp, microbatches=2, compress_grads=True, **kw)
            for kw in ({}, dict(kd4, teacher_params_static=teacher4))]
        out["b"] = dict(layers=TRAIN_DP_LAYERS, one_device_loss=one,
                        steps=[], traffic=None,
                        sp=dict(on=dp.sp, seq_split=dp.seq_split(
                            (TRAIN_BATCH // world, TRAIN_SEQ,
                             cfg.d_model))))
        for k in range(TRAIN_DP_STEPS):
            kd = k == 1
            cstep = csteps[1 if kd else 0]
            tl = (ts.teacher_logits_of(cfg4, b, cfg4, teacher4, dp)
                  if kd else None)
            if kd and dp.data_rank == 0:
                with torch.no_grad():
                    one = float(ts.loss_fn(
                        cfg4, st.params, st.masks, full,
                        ts.teacher_logits_of(cfg4, full, cfg4, teacher4),
                        1.0, KD_BETA, kd_temperature=KD_TEMPERATURE)[0])
            loss_l, _, g = ts.loss_and_grads(
                cfg4, st, b, dp, 2, tl, 1.0, KD_BETA if kd else 0.0,
                over_data=False, kd_temperature=KD_TEMPERATURE)
            del tl
            worst, times = 0.0, {"int8": 0.0, "f32": 0.0}
            counts.clear()

            def both(x, e):
                nonlocal worst
                torch.cuda.synchronize()
                t1 = time.monotonic()
                c, _ = compress.reduce_leaf_int8(x, e, dp)
                torch.cuda.synchronize()
                t2 = time.monotonic()
                xe = x + e
                f = dp.mean_over_data(xe.clone())
                torch.cuda.synchronize()
                times["int8"] += t2 - t1
                times["f32"] += time.monotonic() - t2
                s = dp.max_over_data(xe.abs().max() / 127.0)
                worst = max(worst, float((c - f).abs().max() / (s / 2)))
                return c

            comp = adamw.tree_map(both, g, st.opt_state["ef"])
            red_stats = {k: dict(v) for k, v in counts.items()}
            if out["b"]["traffic"] is None:
                out["b"]["traffic"] = compress.traffic_report(g, st.masks)
            del g
            counts.clear()
            st1, m = cstep(st, b)
            step_stats = {k: dict(v) for k, v in counts.items()}
            # the one-device refresh and update on the compressed mean
            masks, want, _ = sm.maybe_refresh(spec, st.params, comp,
                                              st.masks, st.step, flags)
            want, _, om = adamw.update(
                opt, sm.mask_grads(masks, comp, spec),
                adamw.mask_moments({k: st.opt_state[k] for k in ("m", "v")},
                                   masks, spec), want, st.step)
            del comp
            lr = om["lr"]
            upd_err = max(float((x - y).abs().max()) for x, y in zip(
                adamw.tree_leaves(st1.params), adamw.tree_leaves(want)))
            moved = min(float((x - y).abs().max()) for x, y in zip(
                adamw.tree_leaves(st1.params), adamw.tree_leaves(st.params)))
            same_masks = all(bool(torch.equal(st1.masks[p], masks[p]))
                             for p in masks)
            del want, masks
            torch.cuda.synchronize()
            out["b"]["steps"].append(dict(
                step=st.step, kd=kd, one_device_loss=one,
                loss=m["loss"], local_loss=float(loss_l),
                grad_norm=m["grad_norm"], lr=lr, err_over_bound=worst,
                update_err=upd_err, least_leaf_move=moved,
                masks_equal=same_masks, reduce_s=times,
                reduce_collectives=red_stats, step_collectives=step_stats))
            st = st1
            del st1
        torch.cuda.synchronize()
        out["b"].update(
            wall_s=time.monotonic() - t0,
            state_bytes=sharding.count_bytes({"params": st.params,
                                              "opt": st.opt_state}),
            peak_bytes=torch.cuda.max_memory_allocated())
    finally:
        tdist.destroy_process_group()
    with open(os.path.join(TRAIN_TP_DIR, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _kd_state(torch, cfg, dist=None):
    """The distillation check's start (``KD_*``): the seeded init, its
    MLP masks the one-shot magnitude prune at ``KD_SPARSITY`` (the
    ``dense_last`` layers kept whole), step ``KD_START``, zero moments;
    and the teacher, that seeded init dense. -> (state, teacher), under
    ``dist`` each this rank's shard (the masks chosen on the whole
    weights first, as one device chooses them)."""
    from repro_torch.core import sparse_mlp as sm
    from repro_torch.core.prune_grow import initial_mask
    from repro_torch.distributed import sharding
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.training import step as ts
    whole = registry.init_params(cfg, SEED, DEVICE)
    spec = dataclasses.replace(cfg.blast, s_init=KD_SPARSITY)
    keep = registry.dense_layer_flags(cfg).to(DEVICE)
    masks = {}
    for path in registry.sparse_paths(cfg):
        bi, bo = sm.block_dims_for(spec, path)
        m = initial_mask(dataclasses.replace(spec, b_in=bi, b_out=bo),
                         sm.get_path(whole, path))
        masks[path] = m | keep.view(-1, *[1] * (m.dim() - 1))
    if dist is None:
        params, teacher = adamw.tree_map(torch.clone, whole), whole
    else:
        shd = sharding.state_shardings(cfg, dist.mesh)
        params = sharding.shard_tree(whole, shd.params)
        masks = sharding.shard_tree(masks, shd.masks)
        teacher = sharding.shard_teacher(cfg, whole, dist.mesh)
        del whole
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    return ts.TrainState(step=KD_START, params=params,
                         opt_state=adamw.init(params), masks=masks,
                         generator=gen), teacher


def _kd_steps(torch, src, state, step, counts, dist=None,
              teacher_logits=None) -> dict:
    """``KD_STEPS`` steps of ``step`` from ``state`` on the source's
    batches ``KD_START``... (this rank's rows under ``dist``), each with
    its ``teacher_logits[i]`` where given: losses, gradient norms, each
    step's ``_grad_history`` and collectives, the masks after the last
    step (under 'last_masks')."""
    from repro_torch.distributed import sharding
    out = dict(losses=[], grad_norms=[], history=[], collectives=[],
               sec_per_step=[])
    for i in range(KD_START, KD_START + KD_STEPS):
        batch = {k: torch.as_tensor(v, device=DEVICE)
                 for k, v in src.batch(i).items()}
        if dist is not None:
            batch = sharding.slice_batch(batch, dist)
        if teacher_logits is not None:
            batch["teacher_logits"] = teacher_logits[i]
        if counts is not None:
            counts.clear()
        t0 = time.monotonic()
        state, m = step(state, batch)
        float(m["sparsity"])
        out["sec_per_step"].append(time.monotonic() - t0)
        if counts is not None:
            out["collectives"].append({k: dict(v)
                                       for k, v in counts.items()})
        out["losses"].append(m["loss"])
        out["grad_norms"].append(m["grad_norm"])
        out["anomalies"] = out.get("anomalies", 0) + int(m["anomaly"])
        out["history"].append({p: x.cpu().numpy() for p, x in
                               _grad_history(torch,
                                             state.opt_state["v"]).items()})
    out["last_masks"] = state.masks
    return out


def _tie_margin(torch, spec, wn, gn, step, kb_col):
    """How near one block was to its column's selection boundary in the
    one-device refresh (``mask_from_scores``): the smaller of its |W|
    score's and its |G| score's distance from the boundary of that
    stage, relative to the boundary. ``wn``/``gn`` are one column's
    scores (Kb,), ``kb_col`` the block's row."""
    from repro_torch.core.prune_grow import grow_count
    from repro_torch.core.schedule import keep_count, sparsity_at
    s = sparsity_at(step, s_init=spec.s_init, s_max=spec.s_max,
                    total_steps=spec.total_steps, decay=spec.decay)
    kept = keep_count(s, wn.shape[0])
    grow = grow_count(spec, step, kept)

    def margin(scores, k, x):
        top = torch.sort(scores, descending=True).values
        if k <= 0 or k >= len(top):
            return math.inf
        edge = float(top[k - 1] + top[k]) / 2
        return abs(float(x) - edge) / max(abs(edge), 1e-30)

    keep = torch.zeros_like(wn, dtype=torch.bool)
    keep[torch.sort(wn, descending=True, stable=True).indices[
        :kept - grow]] = True
    mw = margin(wn, kept - grow, wn[kb_col])
    mg = margin(gn.masked_fill(keep, -math.inf), grow, gn[kb_col])
    return min(mw, mg)


def _train_tp_start(torch, cfg, opt, src):
    """Spawn ``train_tp``'s two ranks (``_train_tp_rank``): NCCL with a
    card each, else gloo sharing card 0. They warm up and wait for the
    returned event. -> (processes, event, backend)."""
    import multiprocessing
    world = 2
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    go = multiprocessing.get_context("spawn").Event()
    return (_start_ranks(TRAIN_TP_DIR, _train_tp_rank, world,
                         (world, backend, cfg, opt, src, go)), go, backend)


def _train_tp_readings(torch, ranks, ref, run="a") -> dict:
    """The distances of the ranks' run ``run`` ((a), or 'kd') from the
    one-device record ``ref``, over every rank: the largest relative
    error of the losses, of the gradient norms and of a layer's gradient
    history (the ranks' ``_grad_history`` summed over the model axis
    where a leaf is split, the square roots compared) with the leaf and
    step where it lies, and, where ``ref`` has masks, the gathered
    masks' blocks that differ from one device's, each with its tie
    margin (``_tie_margin``)."""
    out = {"loss": 0.0, "grad_norm": 0.0, "history": 0.0,
           "history_at": None, "differing": [], "blocks": 0}
    for r in ranks:
        a = r[run]
        for key, got, want in (("loss", a["losses"], ref["losses"]),
                               ("grad_norm", a["grad_norms"],
                                ref["grad_norms"])):
            out[key] = max([out[key]] + [abs(x - y) / abs(y)
                                         for x, y in zip(got, want)])
    a0, split = ranks[0][run], ranks[0]["a"]["split"]
    for k, want in enumerate(ref["history"]):
        for p, w in want.items():
            got = (sum(r[run]["history"][k][p] for r in ranks)
                   if split[p] else a0["history"][k][p])
            w = np.sqrt(w)
            e = float(np.max(np.abs(np.sqrt(got) - w)
                             / np.maximum(w, 1e-30)))
            if e > out["history"]:
                out["history"], out["history_at"] = e, (k, p)
    if "masks" not in ref:
        return out
    for st, masks in a0["masks"].items():
        for p, m in masks.items():
            want = ref["masks"][st][p].numpy()
            out["blocks"] += m.size
            spec, wn, gn = ref["scores"][st][p]
            for idx in zip(*np.nonzero(m != want)):
                *lead, kb, nb = idx
                col = tuple(lead) + (slice(None), nb)
                out["differing"].append((st, p, tuple(map(int, idx)),
                                         _tie_margin(torch, spec, wn[col],
                                                     gn[col], st, kb)))
    return out


def phase_train_tp(torch, cfg, opt, src, ref, started):
    """The sharded train step on the card (see the module docstring):
    ``started`` is ``_train_tp_start``'s (ranks warmed up beside the
    chaos chain, which has ended), ``ref`` the train phase's
    one-device record of its first ``TRAIN_TP_STEPS`` steps (losses,
    gradient norms, gradient histories, masks and block scores at each
    refresh). Checks: (a) on every rank the losses and gradient norms
    within ``TRAIN_TP_TOL`` relative and no anomaly, every layer's
    gradient history within ``TRAIN_TP_LAYER_TOL``, the gathered masks
    equal to the one-device masks but for near-ties (``TRAIN_TP_TIE``)
    and to each other, each rank holding about half the params; (b) per
    step every leaf's compressed mean within half a quantization step of
    the f32 mean, the ranks' losses equal, the new params within
    ``TRAIN_DP_UPDATE_TOL`` of the learning rate of the one-device
    refresh and update applied to the compressed mean, the masks equal
    to its, every leaf moved by over a quarter of the learning rate; the
    first loss within ``TRAIN_TP_TOL`` of the one-device loss on the
    whole batch, and so the second (KD) step's; (a)'s sequence
    parallelism and the KD steps as ``_check_train_tp_sp_kd`` holds
    them."""
    from repro_torch.models import registry
    procs, go, backend = started
    t0 = time.monotonic()
    go.set()
    ranks = _join_ranks("train_tp", TRAIN_TP_DIR, procs)
    wall = time.monotonic() - t0
    world = len(ranks)
    kd_ref = _kd_one_device(torch, cfg, opt, src, ranks[0]["kd"]["masks"])
    for r in ranks:
        a = r["a"]
        check(len(a["losses"]) == TRAIN_TP_STEPS and a["anomalies"] == 0,
              f"train_tp (a): rank {r['rank']} steps {a['losses']}")
        for st, masks in a["masks"].items():
            for p, m in masks.items():
                check(np.array_equal(m, ranks[0]["a"]["masks"][st][p]),
                      f"train_tp (a): rank {r['rank']}'s masks differ")
    got = _train_tp_readings(torch, ranks, ref)
    a0 = ranks[0]["a"]
    for key in ("loss", "grad_norm"):
        check(got[key] <= TRAIN_TP_TOL,
              f"train_tp (a): {key} rel err {got[key]} (tol "
              f"{TRAIN_TP_TOL}): {a0['losses']} / {a0['grad_norms']} vs "
              f"one device {ref['losses']} / {ref['grad_norms']}")
    check(got["history"] <= TRAIN_TP_LAYER_TOL,
          f"train_tp (a): gradient history rel err {got['history']} at "
          f"(step, leaf) {got['history_at']}")
    worst_margin = max([m for *_, m in got["differing"]], default=0.0)
    for st, p, idx, mg in got["differing"]:
        check(mg <= TRAIN_TP_TIE,
              f"train_tp (a): {p} block {idx} after step {st} differs "
              f"from one device, margin {mg}")
    full = registry.count_params(cfg)
    for r in ranks:
        check(r["a"]["param_bytes"] <= 0.51 * 4 * full,
              f"train_tp (a): rank {r['rank']} holds "
              f"{r['a']['param_bytes']} param bytes of {4 * full}")
        check(len(r["b"]["steps"]) == TRAIN_DP_STEPS,
              f"train_tp (b): rank {r['rank']} steps {r['b']['steps']}")
        for k, bs in enumerate(r["b"]["steps"]):
            at = f"train_tp (b): rank {r['rank']} step {bs['step']}"
            check(bs["err_over_bound"] <= 1.0 + 1e-5,
                  f"{at}: a compressed mean off by {bs['err_over_bound']} "
                  "half-steps")
            check(bs["loss"] == ranks[0]["b"]["steps"][k]["loss"],
                  f"{at}: the ranks' losses differ")
            check(bs["lr"] > 0 and bs["update_err"]
                  <= TRAIN_DP_UPDATE_TOL * bs["lr"],
                  f"{at}: params {bs['update_err']} off the one-device "
                  f"update on the compressed mean (lr {bs['lr']})")
            check(bs["least_leaf_move"] > bs["lr"] / 4,
                  f"{at}: a leaf moved only {bs['least_leaf_move']}")
            check(bs["masks_equal"], f"{at}: masks differ from the "
                  "one-device refresh on the compressed mean")
    b0 = ranks[0]["b"]
    one = b0["one_device_loss"]
    b_err = abs(b0["steps"][0]["loss"] - one) / abs(one)
    check(b_err <= TRAIN_TP_TOL,
          f"train_tp (b): deferred loss {b0['steps'][0]['loss']} vs one "
          f"device {one}")
    kd_b = b0["steps"][1]
    kd_b_err = abs(kd_b["loss"] - kd_b["one_device_loss"]) / abs(
        kd_b["one_device_loss"])
    check(kd_b["kd"] and kd_b_err <= TRAIN_TP_TOL,
          f"train_tp (b): deferred KD loss {kd_b['loss']} vs one device "
          f"{kd_b['one_device_loss']}")
    per_step = a0["collectives"][1]          # a step without a refresh
    sp, kd = _check_train_tp_sp_kd(torch, ranks, kd_ref)
    emit(phase="train_tp", model=cfg.name, backend=backend, ranks=world,
         devices=[r["device"] for r in ranks], wall_s=wall,
         warm_up_s=[r["warm_s"] for r in ranks],
         a=dict(mesh={"data": 1, "model": world}, layers=cfg.num_layers,
                steps=TRAIN_TP_STEPS, losses=a0["losses"],
                one_device_losses=ref["losses"],
                grad_norms=a0["grad_norms"],
                one_device_grad_norms=ref["grad_norms"],
                loss_rel_err=got["loss"], grad_norm_rel_err=got["grad_norm"],
                tol=TRAIN_TP_TOL, history_rel_err=got["history"],
                history_worst_at=got["history_at"],
                history_tol=TRAIN_TP_LAYER_TOL,
                refresh_steps=sorted(a0["masks"]), mask_blocks=got["blocks"],
                masks_differing=len(got["differing"]),
                worst_tie_margin=worst_margin, tie_tol=TRAIN_TP_TIE,
                sec_per_step=[r["a"]["sec_per_step"] for r in ranks],
                wall_s=[r["a"]["wall_s"] for r in ranks],
                collectives_per_step=per_step,
                collectives_refresh_step=a0["collectives"][0],
                param_bytes_per_rank=[r["a"]["param_bytes"] for r in ranks],
                state_bytes_per_rank=[r["a"]["state_bytes"] for r in ranks],
                single_device_param_bytes=4 * full,
                peak_bytes_per_rank=[r["a"]["peak_bytes"] for r in ranks],
                sp=sp),
         kd=kd,
         b=dict(mesh={"data": world, "model": 1}, layers=TRAIN_DP_LAYERS,
                microbatches=2, compress_grads=True,
                one_device_loss=one, loss_rel_err=b_err,
                update_tol=TRAIN_DP_UPDATE_TOL,
                steps=[dict(bs, local_losses=[r["b"]["steps"][k][
                    "local_loss"] for r in ranks],
                    err_over_int8_bound=max(r["b"]["steps"][k][
                        "err_over_bound"] for r in ranks),
                    reduce_s=[r["b"]["steps"][k]["reduce_s"]
                              for r in ranks])
                       for k, bs in enumerate(b0["steps"])],
                traffic=b0["traffic"], sp=b0["sp"],
                kd_step=dict(step=kd_b["step"], beta=KD_BETA,
                             temperature=KD_TEMPERATURE,
                             one_device_loss=kd_b["one_device_loss"],
                             loss_rel_err=kd_b_err),
                wall_s=[r["b"]["wall_s"] for r in ranks],
                state_bytes_per_rank=[r["b"]["state_bytes"] for r in ranks],
                peak_bytes_per_rank=[r["b"]["peak_bytes"] for r in ranks]),
         note="two ranks sharing one card over gloo: the phase's own "
              "times, not a parallel speed" if backend == "gloo" else "")


def _collective_sums(stats: dict) -> dict:
    """{kind: {bytes: calls}} -> {kind: [calls, bytes]}."""
    return {k: [sum(v.values()), sum(b * n for b, n in v.items())]
            for k, v in stats.items()}


def _kd_one_device(torch, cfg, opt, src, masks) -> dict:
    """The one-device KD steps that ``train_tp``'s sharded ones are held
    against (``_kd_state``, ``_kd_steps``), run in the script's own
    process once the ranks have exited: a whole step of the full model
    needs ≈70 GB of the card (rank 0 beside rank 1 ran it out of
    memory). The teacher's logits of the steps' batches are taken first
    (the forward the step would run, with no gradient) and the teacher
    freed, so the steps carry them as the batches' ``teacher_logits``.
    ``masks``: the ranks' gathered masks after their KD steps, compared
    bitwise."""
    from repro_torch.training import step as ts
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    kst, teacher = _kd_state(torch, cfg)
    logits = {i: ts.teacher_logits_of(
        cfg, {"tokens": torch.as_tensor(src.batch(i)["tokens"],
                                        device=DEVICE)}, cfg, teacher)
        for i in range(KD_START, KD_START + KD_STEPS)}
    del teacher
    kstep = ts.make_train_step(cfg, opt, kd_beta=KD_BETA, teacher_cfg=cfg,
                               kd_temperature=KD_TEMPERATURE)
    ref = _kd_steps(torch, src, kst, kstep, None, teacher_logits=logits)
    last = ref.pop("last_masks")
    ref["masks_equal"] = all(bool(torch.equal(masks[p], m.cpu()))
                             for p, m in last.items())
    ref.update(wall_s=time.monotonic() - t0,
               peak_bytes=torch.cuda.max_memory_allocated())
    del kst, kstep, last, logits
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def _check_train_tp_sp_kd(torch, ranks, ref) -> tuple[dict, dict]:
    """(a)'s sequence parallelism and the distillation steps of
    ``train_tp``: (a)'s stream split along S with reduce-scatters in
    every step; the sharded KD steps' losses and gradient norms within
    ``TRAIN_TP_TOL`` and every layer's gradient history within
    ``TRAIN_TP_LAYER_TOL`` of rank 0's one-device KD steps from the same
    state and batches (``ref``, ``_kd_one_device``), no anomaly, the
    masks (no refresh) equal to its, reduce-scatters in every KD step.
    -> (the sp readings, the KD readings) for the line."""
    a0, r0 = ranks[0]["a"], ranks[0]
    check(a0["sp"]["on"] and a0["sp"]["seq_split"],
          f"train_tp (a): sequence parallelism not engaged {a0['sp']}")
    for r in ranks:
        for k, st in enumerate(r["a"]["collectives"]):
            check(sum(st.get("reduce_scatter", {}).values()) > 0,
                  f"train_tp (a): rank {r['rank']} step {k} issued no "
                  f"reduce-scatter ({st})")
        for k, st in enumerate(r["kd"]["collectives"]):
            check(sum(st.get("reduce_scatter", {}).values()) > 0,
                  f"train_tp kd: rank {r['rank']} step {k} issued no "
                  f"reduce-scatter ({st})")
        check(r["kd"]["anomalies"] == 0 and len(r["kd"]["losses"])
              == KD_STEPS, f"train_tp kd: rank {r['rank']} {r['kd']['losses']}")
    check(ref["masks_equal"], "train_tp kd: the masks differ from one "
          "device's")
    got = _train_tp_readings(torch, ranks, ref, run="kd")
    for key in ("loss", "grad_norm"):
        check(got[key] <= TRAIN_TP_TOL,
              f"train_tp kd: {key} rel err {got[key]} (tol {TRAIN_TP_TOL})"
              f": {r0['kd']['losses']} / {r0['kd']['grad_norms']} vs one "
              f"device {ref['losses']} / {ref['grad_norms']}")
    check(got["history"] <= TRAIN_TP_LAYER_TOL,
          f"train_tp kd: gradient history rel err {got['history']} at "
          f"(step, leaf) {got['history_at']}")
    sp = dict(on=True, stream_split=True,
              collectives_per_step=_collective_sums(a0["collectives"][1]),
              collectives_refresh_step=_collective_sums(
                  a0["collectives"][0]))
    kd = dict(mesh={"data": 1, "model": len(ranks)}, start=KD_START,
              steps=KD_STEPS, beta=KD_BETA, temperature=KD_TEMPERATURE,
              student_sparsity=KD_SPARSITY, teacher="the seeded init, dense",
              one_device_reference="the script's process after the ranks "
                                   "exited, from the same seeded state "
                                   "and batches",
              losses=r0["kd"]["losses"], one_device_losses=ref["losses"],
              grad_norms=r0["kd"]["grad_norms"],
              one_device_grad_norms=ref["grad_norms"],
              loss_rel_err=got["loss"], grad_norm_rel_err=got["grad_norm"],
              history_rel_err=got["history"],
              history_worst_at=got["history_at"], masks_equal=True,
              collectives_per_step=[_collective_sums(s)
                                    for s in r0["kd"]["collectives"]],
              sec_per_step=[r["kd"]["sec_per_step"] for r in ranks],
              one_device_sec_per_step=ref["sec_per_step"],
              wall_s=[r["kd"]["wall_s"] for r in ranks],
              one_device_wall_s=ref["wall_s"],
              teacher_bytes_per_rank=[r["kd"]["teacher_bytes"]
                                      for r in ranks],
              peak_bytes_per_rank=[r["kd"]["peak_bytes"] for r in ranks],
              one_device_peak_bytes=ref["peak_bytes"])
    return sp, kd


def _pinned_bytes(torch) -> dict:
    """Pinned host memory that PyTorch's host allocator holds (in use or
    cached for reuse, in its power-of-two blocks), now and at its peak.
    Its ``active_bytes`` count is not read: on torch 2.11 it grows with
    every reuse of a cached block and exceeds the bytes held."""
    st = torch.cuda.host_memory_stats()
    return {"held": st["allocated_bytes.current"],
            "held_peak": st["allocated_bytes.peak"]}


def phase_train_ckpt(torch, cfg, state, layout):
    """The 12-step trainer state at full depth and width (f32 params,
    both Adam moments, masks, the generator). First the gather alone, as
    a run's first save meets it (the pinned host pool still cold); then
    one blocking save and ``restore_state`` (which verifies as it loads;
    bitwise against the live state), then one async save (the stall
    training sees is the gather, into the now warm pool; the write runs
    behind) and its verify. The pinned host bytes the process holds are
    read after each, the card bytes it reserves before the gather and
    after the restore. Written under the gitignored build/ and deleted;
    ``layout`` (whether it ran beside the chaos children, and the card
    bytes that decided it) goes into its line."""
    from repro_torch.checkpointing.checkpoint import (Checkpointer,
                                                      flatten_tree,
                                                      host_arrays)
    from repro_torch.optim import adamw
    d = os.path.join(ROOT, "build", "chip_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    free = shutil.disk_usage(d).free
    leaves = adamw.tree_leaves({"p": state.params, "o": state.opt_state,
                                "m": state.masks})
    state_bytes = sum(t.numel() * t.element_size() for t in leaves)
    pinned = {"before": _pinned_bytes(torch)}
    reserved = {"before": torch.cuda.memory_reserved()}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    host, _ = host_arrays(flatten_tree(
        {"step": state.step, "params": state.params,
         "opt_state": state.opt_state, "masks": state.masks,
         "rng": state.generator}))
    cold_gather_s = time.monotonic() - t0
    pinned["after_cold_gather"] = _pinned_bytes(torch)
    del host
    ck = Checkpointer(d, keep=1)
    t0 = time.monotonic()
    ck.save(state.step, state, blocking=True)
    blocking_s = time.monotonic() - t0
    nbytes = _dir_bytes(d)
    t0 = time.monotonic()
    back = ck.restore_state(state)          # verifies as it loads
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    reserved["restored"] = torch.cuda.memory_reserved()
    same = (back.step == state.step and all(
        a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(adamw.tree_leaves(
            {"p": back.params, "o": back.opt_state, "m": back.masks}),
            leaves)) and torch.equal(back.generator.get_state(),
                                     state.generator.get_state()))
    del back
    check(same, "train_ckpt: the restored state differs")
    shutil.rmtree(os.path.join(d, f"step_{state.step:08d}"))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ck.save(state.step + 1, state)
    stall_s = time.monotonic() - t0
    pinned["during_async_write"] = _pinned_bytes(torch)
    ck.wait()
    write_s = time.monotonic() - t0 - stall_s
    pinned["after"] = _pinned_bytes(torch)
    t0 = time.monotonic()
    ok = ck.verify(state.step + 1)
    verify_s = time.monotonic() - t0
    check(ok, "train_ckpt: the async save does not verify")
    shutil.rmtree(d)
    emit(phase="train_ckpt", depth=cfg.num_layers, dtype="float32",
         state_bytes=state_bytes, bytes_on_disk=nbytes,
         free_disk_bytes_before=free, cold_gather_s=cold_gather_s,
         blocking_save_s=blocking_s, warm_gather_stall_s=stall_s,
         async_write_s=write_s, verify_s=verify_s,
         restore_with_verify_s=restore_s, restored_bitwise=same,
         pinned_host_bytes=pinned, card_reserved_bytes=reserved,
         layout=layout)


def _obs_train_pair(off, on):
    """``obs_train``: two chaos children in the train_chaos setting (two
    layers, full width, f32, deterministic algorithms) train
    ``OBS_PAIR_STEPS`` steps from the same seed, one untraced (``off``)
    and one with a ``trace_dir`` (``on``), side by side: every TrainState
    leaf bitwise equal."""
    r0, m0, w0, out0 = off
    check(r0.returncode == 0, f"obs_train pair, off: {r0.stderr[-2000:]}")
    r1, m1, w1, out1 = on
    check(r1.returncode == 0, f"obs_train pair, on: {r1.stderr[-2000:]}")
    with np.load(out0) as off, np.load(out1) as on:
        check(set(off.files) == set(on.files), "obs_train pair: keys")
        unequal = sorted(k for k in off.files
                         if not np.array_equal(off[k], on[k]))
        leaves = len(off.files)
    check(unequal == [], f"obs_train pair: {unequal} differ with tracing on")
    tr = m1["trace"]
    check(m0["trace"] is None
          and tr["records"].get("train.step") == OBS_PAIR_STEPS,
          f"obs_train pair: records {tr['records']}")
    return {"steps": OBS_PAIR_STEPS, "leaves": leaves, "bitwise": True,
            "records": tr["records"],
            "train_step_ms": [x * 1e3 for x in tr["train_step_s"]],
            "child_wall_s": {"off": w0, "on": w1},
            "nondeterministic_ops": sorted(set(
                m0["nondeterministic_ops"] + m1["nondeterministic_ops"]))}


def _obs_train_rewind(tf, wd):
    """``obs_postmortems`` of a training rewind: the chaos child's own
    two-layer tiny model (``default_chaos_spec``) on the card, NaN
    gradients at steps 5, 6 and 7 with checkpoints every 4, traced: the
    guard rewinds at step 7 to step 4 and the child finishes; its tracer
    dumps one ``train_rewind`` postmortem, whose frozen records hold the
    three ``train.anomaly`` events and end with the last."""
    d = os.path.join(wd, "rewind")
    os.makedirs(d)
    pm_dir = os.path.join(d, "pm")
    spec = tf.default_chaos_spec(d, ckpt_dir=os.path.join(d, "ck"),
                                 steps=OBS_REWIND_STEPS,
                                 nan_at=OBS_REWIND_NAN, device=DEVICE,
                                 trace_dir=pm_dir)
    t0 = time.monotonic()
    r = tf.run_child(spec, os.path.join(d, "spec.json"), timeout=600)
    wall = time.monotonic() - t0
    check(r.returncode == 0, f"obs rewind child: {r.stderr[-2000:]}")
    with open(spec["meta_out"]) as f:
        meta = json.load(f)
    pms = meta["trace"]["postmortems"]
    check([p["reason"] for p in pms] == ["train_rewind"]
          and pms[0]["meta"]["step"] == OBS_REWIND_NAN[-1]
          and pms[0]["names"].count("train.anomaly") == 3
          and pms[0]["names"][-1] == "train.anomaly"
          and meta["counters"]["rewinds"] == 1,
          f"obs rewind child: {pms}, counters {meta['counters']}")
    check(sorted(os.listdir(pm_dir)) == ["postmortem_0000_train_rewind.json"],
          f"obs rewind child: files {os.listdir(pm_dir)}")
    return {"postmortems": [{k: p[k] for k in ("reason", "meta", "records")}
                            for p in pms],
            "records": meta["trace"]["records"], "child_wall_s": wall,
            "counters": meta["counters"]}


def _state_diff(want, got):
    """The keys of two chaos children's final states (``.npz``) if they
    differ, else (leaves unequal, largest absolute difference among the
    inexact ones). Each leaf is read once from each file."""
    with np.load(want) as zw, np.load(got) as zg:
        if set(zg.files) != set(zw.files):
            return sorted(set(zg.files) ^ set(zw.files)), None
        worst, unequal = 0.0, []
        for k in zw.files:
            a, b = zg[k], zw[k]
            if np.array_equal(a, b):
                continue
            unequal.append(k)
            if not _exact_leaf(k):
                worst = max(worst, float(np.max(np.abs(
                    a.astype(np.float64) - b))))
    return unequal, worst


def _exact_leaf(k):
    return k.startswith("masks/") or k in ("step", "rng")


def _corrupt_newest(ck):
    """Flip one byte in the middle of the newest checkpoint's arrays."""
    f = os.path.join(ck, f"step_{CHAOS_STEPS:08d}", "arrays.npz")
    with open(f, "r+b") as fh:
        fh.seek(0, os.SEEK_END)
        off = fh.tell() // 2
        fh.seek(off)
        b = fh.read(1)
        fh.seek(off)
        fh.write(bytes([b[0] ^ 1]))


def phase_train_chaos(torch, cfg, beside=None):
    """The SIGKILL chaos at two layers and full width in f32, through the
    chaos child (``training/faults.py``; deterministic algorithms, each
    child a process of its own): child B runs 12 steps uninterrupted;
    child A is killed at step 11 (newest intact checkpoint 8, or 4 when
    the kill lands while step 8's async write runs; a refresh at 10 in
    the replay either way) and child A2 resumes from it; then A2's newest
    checkpoint (12) is corrupted and child A3 must fall back to 8 and
    end where B ends. Masks, step and generator must be bitwise equal;
    params and moments too, or the nondeterministic op is named and the
    largest difference printed.

    The children are independent processes compared by their final
    states and postmortems, never by their time, so they run side by
    side beside the A -> A2 -> A3 chain in threads: ``beside()`` first,
    on a thread of its own (``train_ckpt``: the full-depth state, ≈30 GB
    of the card while it restores), then the full-width ones
    ``CHAOS_SIDE`` at a time, the ``obs_train`` pair, then B (a
    full-width child holds ≈14 GB or more of the card: the chain and all
    four others at once ran out of its 80 GB); on one more thread the
    rewind child (a tiny model), then the comparisons of the pair and of
    A2 with B while A3 runs (each reads two 4.6 GB states). Every
    ``child_wall_s`` is then a shared card's (``train_tp``'s ranks warm
    up beside them too)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.checkpointing.checkpoint import Checkpointer
    from repro_torch.training import faults as tf
    wd = os.path.join(ROOT, "build", "chip_chaos")
    shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(wd)
    ck = os.path.join(wd, "ck")
    model = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
             if f.name != "blast"}
    model.update(num_layers=CHAOS_LAYERS, compute_dtype="float32",
                 name=cfg.name + "-chaos")
    blast = dataclasses.asdict(cfg.blast)
    blast.update(total_steps=20, step_size=5, dense_last=1)
    common = dict(model=model, blast=blast, steps=CHAOS_STEPS,
                  seq_len=TRAIN_SEQ,
                  batch=TRAIN_BATCH, data_seed=SEED, device=DEVICE)

    def child(name, **kw):
        spec = tf.default_chaos_spec(
            wd, **dict(common, out=os.path.join(wd, f"{name}.npz"),
                       meta_out=os.path.join(wd, f"{name}.json"), **kw))
        t0 = time.monotonic()
        r = tf.run_child(spec, os.path.join(wd, f"{name}_spec.json"),
                         timeout=600)
        wall = time.monotonic() - t0
        meta = None
        if r.returncode == 0:
            with open(spec["meta_out"]) as f:
                meta = json.load(f)
        return r, meta, wall, spec["out"]

    def diff_with_b(b, path):
        rb, _, _, out_b = b.result()
        return _state_diff(out_b, path) if rb.returncode == 0 else None

    def pair(off, on):
        return _obs_train_pair(off.result(), on.result())

    gate = threading.Event()     # set once ``beside`` is done

    def after_beside(name, **kw):
        gate.wait()
        return child(name, **kw)

    with ThreadPoolExecutor(max_workers=1) as small, \
            ThreadPoolExecutor(max_workers=1) as first, \
            ThreadPoolExecutor(max_workers=CHAOS_SIDE) as pool:
        side = {"beside": first.submit(beside or (lambda: None))}
        side["beside"].add_done_callback(lambda f: gate.set())
        side.update(
            off=pool.submit(after_beside, "obs_off", steps=OBS_PAIR_STEPS),
            on=pool.submit(after_beside, "obs_on", steps=OBS_PAIR_STEPS,
                           trace_dir=os.path.join(wd, "obs_pair_pm")),
            b=pool.submit(after_beside, "b"),
            rewind=small.submit(_obs_train_rewind, tf, wd))
        side["pair"] = small.submit(pair, side["off"], side["on"])
        ra, _, wa, _ = child("a", ckpt_dir=ck, kill_at=CHAOS_KILL)
        # the async write of step 8 may still be running at the kill: then
        # only its .tmp is on disk and the newest intact checkpoint is 4
        torn = sorted(n for n in os.listdir(ck) if n.endswith(".tmp"))
        newest = Checkpointer(ck).latest_intact_step()
        ra2, m2, w2, out_a2 = child("a2", ckpt_dir=ck)
        if ra2.returncode == 0:
            side["a2_diff"] = small.submit(diff_with_b, side["b"], out_a2)
            _corrupt_newest(ck)
            ra3, m3, w3, out_a3 = child("a3", ckpt_dir=ck)
        side = {k: f.result() for k, f in side.items()}
    rb, mb, wb, out_b = side["b"]
    check(rb.returncode == 0, f"chaos child B failed: {rb.stderr[-2000:]}")
    check(ra.returncode == -signal.SIGKILL,
          f"chaos child A was not killed: {ra.returncode} "
          f"{ra.stderr[-2000:]}")
    check(newest in (4, 8), f"chaos: newest intact checkpoint {newest}")
    check(ra2.returncode == 0, f"chaos child A2: {ra2.stderr[-2000:]}")
    check(m2["resumed_from"] == newest, f"chaos A2 resumed from "
          f"{m2['resumed_from']}, not {newest}")
    check(ra3.returncode == 0, f"chaos child A3: {ra3.stderr[-2000:]}")
    check(m3["resumed_from"] == CHAOS_STEPS - 4
          and m3["counters"]["ckpt_fallbacks"] == 1,
          f"chaos A3: resumed from {m3['resumed_from']}, counters "
          f"{m3['counters']}")
    nondet = sorted(set(mb["nondeterministic_ops"] + m2[
        "nondeterministic_ops"] + m3["nondeterministic_ops"]))
    diffs = {}
    for name, (unequal, worst) in (("a2", side["a2_diff"]),
                                   ("a3", _state_diff(out_b, out_a3))):
        check(worst is not None, f"chaos {name}: keys {unequal} differ")
        for k in unequal:
            check(not _exact_leaf(k), f"chaos {name}: {k} not bitwise")
        diffs[name] = {"unequal_leaves": len(unequal),
                       "max_abs_diff": worst}
        check(not unequal or nondet,
              f"chaos {name}: {len(unequal)} leaves differ by up "
              f"to {worst} with no nondeterministic op named")
    pair = side["pair"]
    rewind = side["rewind"]
    shutil.rmtree(wd)
    emit(phase="obs_train", run="pair", **pair)
    emit(phase="obs_postmortems", drive="train_rewind", **rewind)
    emit(phase="train_chaos", layers=CHAOS_LAYERS, dtype="float32",
         steps=CHAOS_STEPS, kill_at=CHAOS_KILL, torn_at_kill=torn,
         resumed_from=m2["resumed_from"],
         fallback_resumed_from=m3["resumed_from"],
         ckpt_fallbacks=m3["counters"]["ckpt_fallbacks"],
         bitwise=all(d["unequal_leaves"] == 0 for d in diffs.values()),
         diffs=diffs, nondeterministic_ops=nondet,
         child_wall_s={"b": wb, "a_killed": wa, "a2": w2, "a3": w3},
         child_train_s={"b": mb["wall_s"], "a2": m2["wall_s"],
                        "a3": m3["wall_s"]},
         resume_verify_s={"a2": m2["verify_latency_s"],
                          "a3": m3["verify_latency_s"]})


# ------------------------------------------------------ the --arch registry
def _mlp_of(cfg, tree, j):
    """Layer ``j``'s MLP params (views), in layer order: a local/global
    model alternates its two stacks."""
    from repro_torch.models import transformer
    if cfg.layer_pattern == "local_global":
        stack, i = ("layers_local", "layers_global")[j % 2], j // 2
    else:
        stack, i = "layers", j
    return transformer._layer_view(tree[stack], i)["mlp"]


def _paged_line(torch, card, timer, gen, phase, kvh, g, hd, attn_scale,
                cap, window, **extra):
    """Paged decode at B = ``ARCH_DECODE_B`` lanes over R =
    ``ARCH_DECODE_R`` pages of 16 (a pool of 256 pages), ``kvh`` kv heads
    of ``g`` query heads each, bf16, held against its plain version
    within ``ulp_tol``; the library yardstick is SDPA on pre-gathered
    pages (without the logit softcap, which SDPA lacks)."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    dt, es = torch.bfloat16, 2
    b, r = ARCH_DECODE_B, ARCH_DECODE_R
    ps, n_pages = ENGINE["page_size"], 256
    scale = attn_scale or 1.0 / math.sqrt(hd)
    pk_, pv_ = (torch.randn(n_pages, ps, kvh, hd, generator=gen,
                            device=DEVICE).to(dt) for _ in range(2))
    bt = torch.randperm(n_pages, generator=gen, device=DEVICE)[
        :b * r].reshape(b, r).to(torch.int32)
    q4 = torch.randn(b, kvh, g, hd, generator=gen, device=DEVICE).to(dt)
    lens = torch.randint(1, r * ps + 1, (b,), generator=gen, device=DEVICE)
    slots = torch.arange(r * ps, device=DEVICE)[None].expand(b, -1)
    bias = pa.mask_bias((lens - 1)[:, None], slots, window).contiguous()
    valid = int(lens.sum())
    k_fn = lambda: pa.paged_flash_decode(  # noqa: E731
        q4, pk_, pv_, bt, bias, scale=scale, softcap=cap)
    p_fn = lambda: pa.paged_flash_decode_plain(  # noqa: E731
        q4, pk_, pv_, bt, bias, scale=scale, softcap=cap)
    gk = pk_[bt.long()].reshape(b, r * ps, kvh, hd).transpose(1, 2)
    gv = pv_[bt.long()].reshape(b, r * ps, kvh, hd).transpose(1, 2)
    qs = q4.reshape(b, kvh * g, 1, hd)
    am = (bias > pa.NEG_INF / 2)[:, None, None, :]
    l_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qs, gk, gv, attn_mask=am, scale=scale, enable_gqa=True)
    nbytes = (q4.numel() * es + valid * kvh * hd * es * 2 + bt.numel() * 4
              + bias.numel() * 4 + q4.numel() * 4)
    return _record(
        torch, card, phase, "paged_flash_decode", dt, [b, r], k_fn(),
        p_fn(), timer.ms(k_fn), timer.ms(p_fn), timer.ms(l_fn), nbytes,
        4 * valid * kvh * g * hd, kv_heads=kvh, G=g, head_dim=hd,
        scale=scale, softcap=cap, window=window,
        library_note="SDPA without the logit softcap" if cap else None,
        **extra)


def _dense_of(torch, p):
    """The dense (K, N) weight of a pack, or (E, K, N) of an expert
    batch."""
    from repro_torch.core.packing import unpack
    if p.idx.dim() == 2:
        return unpack(p)
    return torch.stack([unpack(p.layer(e)) for e in range(p.idx.shape[0])])


def _mlp_lines(torch, card, timer, gen, phase, lead, m, down, gate, up,
               jgate, jup, act, **base):
    """``bspmm`` on the down projection, the split GLU and the joint GLU
    (up taking gate's mask) at ``m`` rows in bf16 (``lead`` (E,): an
    expert batch, m rows per expert, one launch each), each held against
    its plain version within ``ulp_tol``. The library yardstick is
    ``torch.matmul`` on the dense weights (``torch.bmm`` over an expert
    batch; gate and up side by side for the GLUs). Bytes count every
    packed block and idx entry once, X and Y once."""
    from repro_torch.kernels import bspmm as kb, ops
    dt, es = torch.bfloat16, 2
    h = torch.randn(*lead, m, down.kb * down.b_in, generator=gen,
                    device=DEVICE).to(dt)
    x = torch.randn(*lead, m, gate.kb * gate.b_in, generator=gen,
                    device=DEVICE).to(dt)
    wd = _dense_of(torch, down)
    wgu = torch.cat([_dense_of(torch, gate), _dense_of(torch, up)], dim=-1)
    wgu_j = torch.cat([_dense_of(torch, jgate), _dense_of(torch, jup)],
                      dim=-1)
    rows_out = math.prod(lead) * m
    n_ff = gate.nb * gate.b_out
    blk = lambda p: p.blocks.numel() * es + p.idx.numel() * 4  # noqa: E731
    rows = {
        "bspmm": (lambda: kb.bspmm(h, down),
                  lambda: ops.bspmm_plain(h, down),
                  lambda: torch.matmul(h, wd),
                  h.numel() * es + blk(down)
                  + rows_out * down.nb * down.b_out * es,
                  ops.flops_bspmm(m, down), kb.launch_plan(h, down), down),
        "fused_glu_split": (
            lambda: kb.fused_glu(x, gate, up, act=act),
            lambda: ops.fused_glu_plain(x, gate, up, act),
            lambda: torch.matmul(x, wgu),
            x.numel() * es + blk(gate) + blk(up) + rows_out * n_ff * es,
            ops.flops_bspmm(m, gate) + ops.flops_bspmm(m, up),
            kb.launch_plan(x, gate, up), gate),
        "fused_glu_joint": (
            lambda: kb.fused_glu(x, jgate, jup, act=act),
            lambda: ops.fused_glu_plain(x, jgate, jup, act),
            lambda: torch.matmul(x, wgu_j),
            x.numel() * es + jgate.blocks.numel() * es * 2
            + jgate.idx.numel() * 4 + rows_out * n_ff * es,
            ops.flops_bspmm(m, jgate) * 2, kb.launch_plan(x, jgate, jup),
            jgate),
    }
    out = {}
    for name, (k_fn, p_fn, l_fn, nbytes, ops_, plan, p) in rows.items():
        out[name] = _record(
            torch, card, phase, name, dt, [*lead, m], k_fn(), p_fn(),
            timer.ms(k_fn), timer.ms(p_fn), timer.ms(l_fn), nbytes, ops_,
            plan=plan.describe(), act=act, kb=p.kb, nb=p.nb, nnz=p.nnz,
            **base)
    return out


def phase_arch_kernels(torch, card, timer, cfg, packed, jgate, jup):
    """The kernels at one full-width layer of ``cfg`` (layer 0, s = 0.8,
    bf16): ``bspmm``, the split GLU and the joint GLU at M = 8 rows
    (``_mlp_lines``), and paged decode at B = 8 lanes over R = 16 pages of
    16 with the model's kv heads, G, head dim, scale, softcap and window
    (``_paged_line``)."""
    from repro_torch.models import attention
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    mlp0 = _mlp_of(cfg, packed, 0)
    base = dict(arch=cfg.name, block=[cfg.blast.b_in, cfg.blast.b_out])
    out = _mlp_lines(torch, card, timer, gen, "arch_kernel", (), ARCH_M,
                     mlp0["w_down"], mlp0["w_gate"], mlp0["w_up"], jgate,
                     jup, cfg.mlp_act, **base)
    hq, kvh = attention.eff_heads(cfg)
    out["paged_flash_decode"] = _paged_line(
        torch, card, timer, gen, "arch_kernel", kvh, hq // kvh,
        cfg.head_dim, cfg.attn_scale, float(cfg.attn_logit_softcap or 0.0),
        cfg.sliding_window, **base)
    return out


def _arch_parity(torch, cfg, packed, dense, prompts):
    """``phase_e2e``'s comparison on the model's first two layers: on the
    hidden states the pruned-dense model feeds each MLP, the packed MLP
    (fused GLU + BSpMM kernels) against the dense one (``torch.matmul``),
    then each prompt's next-token logits, each within 2**-5 of the
    output's magnitude."""
    from repro_torch.models import transformer
    cfg2 = dataclasses.replace(cfg, num_layers=PARITY_DEPTH)
    p2 = _first_layers(packed, PARITY_DEPTH)
    d2 = _first_layers(dense, PARITY_DEPTH)
    worst = {"mlp": 0.0, "logits": 0.0}

    def hold(kind, got, want, where):
        check(bool(torch.isfinite(got).all()),
              f"{cfg.name}: non-finite packed {where}")
        tol = 2.0 ** -5 * float(want.abs().max())
        err = float((got - want).abs().max())
        worst[kind] = max(worst[kind], err / tol)
        check(err <= tol, f"{cfg.name} {where}: packed vs dense differ by "
                          f"{err} > {tol}")

    hs = _mlp_inputs(torch, cfg2, d2, prompts)
    with torch.inference_mode():
        for i, h in enumerate(hs):
            j = i % PARITY_DEPTH
            hold("mlp", transformer.mlp_forward(
                     cfg2, _mlp_of(cfg2, p2, j), h)[0].float(),
                 transformer.mlp_forward(
                     cfg2, _mlp_of(cfg2, d2, j), h)[0].float(),
                 f"layer {j} MLP")
    for p in prompts:
        hold("logits", _last_logits(torch, cfg2, p2, p),
             _last_logits(torch, cfg2, d2, p), "logits")
    return {"depth": PARITY_DEPTH, "prompts": len(prompts),
            "mlps_checked": len(hs),
            "mlp_max_err_over_tol": worst["mlp"],
            "logits_max_err_over_tol": worst["logits"],
            "tol_fraction": 2.0 ** -5}


def phase_serve_arch(torch, card):
    """The ``--arch`` registry and the serving launcher on the four dense
    architectures, packed at s = 0.8 (``ARCH_RUNS``): ``qwen2-7b`` whole
    through ``launch.serve.main`` (params only; the f32 copy is dropped
    once packed), the others at full width with their depth cut, through
    ``prune_and_pack`` and ``launch.serve._serve``. Each serves the
    launcher's 8 prompts of 64 tokens x 32 new on the paged engine, the
    launch counters reset just before and read just after. Then, per
    architecture, the kernel lines of one full-width layer and the
    packed-vs-dense check on its first two layers (for qwen2-7b on a
    fresh two-layer cut of its config). Returns the serving runs'
    counts."""
    import repro_torch.launch.serve as launcher
    from repro_torch.configs import get_config
    from repro_torch.models import attention, registry
    from repro_torch.serving import export
    t_phase = time.monotonic()
    timer = Timer(torch)
    rng = np.random.default_rng(SEED + 3)
    served = []
    for arch, depth in ARCH_RUNS.items():
        full = get_config(arch)
        argv = ["--arch", arch, "--packed", "--batch", str(ARCH_BATCH),
                "--prompt-len", str(ARCH_PROMPT), "--new-tokens",
                str(ARCH_TOKENS)]
        gc.collect()              # engines hold their weights in cycles
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        if depth is None:         # the whole model, through main()
            cfg = full
            _reset_counts()
            res = launcher.main(argv)
            counts = _read_counts()
            tokens, stats = res["tokens"], res["stats"]
            times, memory = res["seconds"], res["memory"]
        else:
            cfg = dataclasses.replace(full, num_layers=depth)
            params = registry.init_params(cfg, SEED, DEVICE)
            torch.cuda.synchronize()
            times = {"init_s": time.monotonic() - t0}
            packed = launcher.prune_and_pack(cfg, params, ARCH_SPARSITY,
                                             True, times=times)
            memory = export.memory_report(cfg, packed)
            args = launcher.build_parser().parse_args(argv)
            _reset_counts()
            tokens, stats = launcher._serve(cfg, packed, args, DEVICE)
            counts = _read_counts()
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated()
        served.append(counts)
        hq, kvh = attention.eff_heads(full)
        emit(phase="serve_arch", arch=arch, layers=cfg.num_layers,
             reduced=None if depth is None else [
                 f"num_layers {full.num_layers} -> {depth}"
                 + (f" ({depth // 2} local/global pairs)"
                    if full.layer_pattern == "local_global" else "")],
             entry=("launch.serve.main" if depth is None
                    else "launch.serve.prune_and_pack + _serve"),
             d_model=full.d_model, d_ff=full.d_ff, vocab=full.vocab_size,
             q_heads=hq, kv_heads=kvh, G=hq // kvh, head_dim=full.head_dim,
             block=[full.blast.b_in, full.blast.b_out], act=full.mlp_act,
             sparsity=ARCH_SPARSITY, batch=ARCH_BATCH,
             prompt_len=ARCH_PROMPT, new_tokens=ARCH_TOKENS,
             tok_per_s=stats["tok_per_s"], ttft_p50_s=stats["ttft_p50_s"],
             ttft_p95_s=stats["ttft_p95_s"],
             generated_tokens=stats["generated_tokens"],
             weight_bytes=memory["bytes"], max_memory_allocated=peak,
             allocated_before=before,
             **times, wall_s=wall, launches=counts,
             sliding_window=full.sliding_window,
             window_binds=bool(full.sliding_window)
             and ARCH_PROMPT + ARCH_TOKENS > full.sliding_window)
        check(len(tokens) == ARCH_BATCH and all(
            t.size == ARCH_TOKENS and bool(((t >= 0)
                                            & (t < full.vocab_size)).all())
            for t in tokens), f"{arch}: a stream is short or leaves the "
                              "vocabulary")
        for k in PAGED:
            check(counts[k] > 0, f"{arch}: kernel {k} never launched")
        if depth is None:         # a fresh two-layer cut for the checks
            cfg = dataclasses.replace(full, num_layers=PARITY_DEPTH)
            params = registry.init_params(cfg, SEED, DEVICE)
            packed = launcher.prune_and_pack(cfg, params, ARCH_SPARSITY,
                                             True)
        masks = launcher.one_shot_masks(cfg, params, ARCH_SPARSITY)
        dense = launcher.prune_and_pack(cfg, params, ARCH_SPARSITY, False,
                                        masks=masks)
        # up takes gate's mask: the joint GLU's operands
        joint = launcher.prune_and_pack(
            cfg, params, ARCH_SPARSITY, True,
            masks={k: masks[k.replace("w_up", "w_gate")] for k in masks})
        del params, masks
        jmlp = _mlp_of(cfg, joint, 0)
        jgate, jup = jmlp["w_gate"], jmlp["w_up"]
        check(jgate.joint and jup.joint, f"{arch}: joint marking is wrong")
        prompts = [rng.integers(0, full.vocab_size, size=(int(n),))
                   .astype(np.int32) for n in
                   rng.integers(ARCH_PROMPT, 2 * ARCH_PROMPT + 1,
                                size=ARCH_PARITY_PROMPTS)]
        kern = phase_arch_kernels(torch, card, timer, cfg, packed, jgate,
                                  jup)
        emit(phase="arch_parity", arch=arch,
             **_arch_parity(torch, cfg, packed, dense, prompts),
             kernels={k: {f: v[f] for f in ("ms", "bound_ms", "library_ms")}
                      for k, v in kern.items()})
        del packed, dense, joint, jmlp, jgate, jup
    torch.cuda.empty_cache()
    emit(phase="serve_arch_total", seconds=time.monotonic() - t_phase)
    return served


def _moe_serve_run(torch, cfg, packed, args, sync=False):
    """One ``launch.serve._serve`` run, the launch counters and the MoE
    layer's ``CALLS`` reset just before and read just after. With ``sync``
    the synchronizing CUDA calls are counted
    (``set_sync_debug_mode("warn")``). Returns (tokens, stats, counts,
    MoE layer calls by (tokens, C), sync calls, wall seconds)."""
    import warnings
    import repro_torch.launch.serve as launcher
    from repro_torch.models import moe
    torch.cuda.synchronize()
    _reset_counts()
    moe.CALLS.clear()
    t0 = time.monotonic()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if sync:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            tokens, stats = launcher._serve(cfg, packed, args, DEVICE)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    counts = _read_counts()
    syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
    return (tokens, stats, counts, dict(moe.CALLS), syncs,
            time.monotonic() - t0)


def phase_moe_kernels(torch, card, timer, cfg, packed, joint1, caps):
    """The kernels of one full-width MoE layer (layer 0's experts, s =
    0.8, bf16): the expert-batched ``bspmm`` (down), split GLU and joint
    GLU (``joint1``: up taking gate's mask) over all E experts in one
    launch each, at every capacity C in ``caps`` (those the served runs
    used: decode's and the prefill and mixed calls'; ``_mlp_lines``;
    every expert is computed at capacity, so the bound counts every
    expert's blocks); and, for a model with G > 8 query heads per kv
    head, paged decode at its G beside G = 8 (``_paged_line``)."""
    from repro_torch.models import attention, transformer
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    mlp0 = transformer._layer_view(packed["layers"], 0)["mlp"]
    jm = transformer._layer_view(joint1["layers"], 0)["mlp"]
    check(jm["w_gate"].joint and jm["w_up"].joint,
          f"{cfg.name}: joint marking is wrong")
    e = cfg.num_experts
    base = dict(arch=cfg.name, block=[cfg.blast.b_in, cfg.blast.b_out])
    out = {}
    for c in caps:
        out[c] = _mlp_lines(torch, card, timer, gen, "moe_kernel", (e,), c,
                            mlp0["w_down"], mlp0["w_gate"], mlp0["w_up"],
                            jm["w_gate"], jm["w_up"], cfg.mlp_act, C=c,
                            experts=e, **base)
    hq, kvh = attention.eff_heads(cfg)
    if hq // kvh > 8:
        for g in (hq // kvh, 8):
            out[f"paged_G{g}"] = _paged_line(
                torch, card, timer, gen, "moe_kernel", kvh, g, cfg.head_dim,
                cfg.attn_scale, float(cfg.attn_logit_softcap or 0.0),
                cfg.sliding_window, **base)
    return out


def phase_serve_moe(torch, card):
    """The MoE family (``models/moe.py``) through the serving launcher:
    each of ``MOE_RUNS`` at full width with its depth cut, packed at s =
    0.8 by ``launch.serve.prune_and_pack`` (every layer pruned: dense_last
    is not applied), serving the launcher's 8 prompts of 64 tokens x 32
    new through ``launch.serve._serve`` on the paged engine, phased, then
    ``--mixed``, then phased again. Per run the launch counters and the
    MoE layer's calls by (tokens, C) (``moe.CALLS``) are reset just before
    and read just after; every MoE layer of every model call
    launches the fused GLU and ``bspmm`` once for all its experts (once
    more for deepseek's shared experts), so launches per call do not grow
    with E; the repeated phased run's streams equal the first's bitwise;
    the repeated run makes as many synchronizing CUDA calls as the same
    traffic with every MLP replaced by a zero stub (the MoE layer adds
    none). Then the kernel lines of one MoE layer at every C the runs
    used and, on the first two
    layers, the packed model against its pruned-dense export (the
    ``arch_parity`` check). Returns the runs' launch counts and, per
    model, what ``serve_ep`` needs: the config, the packed tree and layer
    0's joint export in host memory (the card keeps none of them), the
    file in ``EP_WEIGHTS`` a thread is writing the tree to (a future of
    its seconds), the launcher's arguments and prompts, and the phased
    and mixed runs' streams and MoE layer calls."""
    import repro_torch.launch.serve as launcher
    from repro_torch.configs import get_config
    from repro_torch.models import registry, transformer
    from repro_torch.serving import export
    t_phase = time.monotonic()
    timer = Timer(torch)
    rng = np.random.default_rng(SEED + 4)
    served, mlp, ep = [], transformer.mlp_forward, {}
    shutil.rmtree(EP_WEIGHTS, ignore_errors=True)
    os.makedirs(EP_WEIGHTS)
    saver = concurrent.futures.ThreadPoolExecutor(1)
    for arch, depth in MOE_RUNS.items():
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=depth)
        argv = ["--arch", arch, "--packed", "--batch", str(ARCH_BATCH),
                "--prompt-len", str(ARCH_PROMPT), "--new-tokens",
                str(ARCH_TOKENS)]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stages = {}

        def stage(name):
            """Bytes allocated after a set-up stage, and its peak."""
            torch.cuda.synchronize()
            stages[name] = [torch.cuda.memory_allocated(),
                            torch.cuda.max_memory_allocated()]
            torch.cuda.reset_peak_memory_stats()

        t0 = time.monotonic()
        params = registry.init_params(cfg, SEED, DEVICE)
        torch.cuda.synchronize()
        times = {"init_s": time.monotonic() - t0}
        stage("init")
        packed = launcher.prune_and_pack(cfg, params, ARCH_SPARSITY, True,
                                         times=times)
        stage("prune_and_pack")
        memory = export.memory_report(cfg, packed)
        # the exports the checks need: joint (up taking gate's mask) on
        # layer 0, pruned-dense on the first two layers
        cfg2 = dataclasses.replace(cfg, num_layers=PARITY_DEPTH)
        p2 = _first_layers(params, PARITY_DEPTH)
        masks = launcher.one_shot_masks(cfg2, p2, ARCH_SPARSITY)
        jmasks = {k: masks[k.replace("_up", "_gate")][:1] for k in masks}
        joint1 = launcher.prune_and_pack(
            dataclasses.replace(cfg, num_layers=1), _first_layers(params, 1),
            ARCH_SPARSITY, True, masks=jmasks)
        stage("joint_layer0")
        dense = launcher.prune_and_pack(cfg2, p2, ARCH_SPARSITY, False,
                                        masks=masks)
        stage("dense_two_layers")
        del params, p2, masks, jmasks
        gc.collect()
        torch.cuda.empty_cache()
        stage("params_freed")

        runs = {}
        for name, extra, sync in (("phased", [], False),
                                  ("mixed", ["--mixed"], False),
                                  ("phased_repeat", [], True)):
            args = launcher.build_parser().parse_args(argv + extra)
            runs[name] = _moe_serve_run(torch, cfg, packed, args, sync)
        # the same traffic with every MLP a zero stub: the engine's own
        # synchronizing calls (eos is off, so the steps are the same)
        transformer.mlp_forward = (
            lambda cfg_, p, x, masks=None, **kw:
            (torch.zeros_like(x), 0.0))
        try:
            stub = _moe_serve_run(torch, cfg, packed, launcher.build_parser()
                                  .parse_args(argv), True)
        finally:
            transformer.mlp_forward = mlp
        stage("served")
        per_call = 1 + bool(cfg.num_shared_experts)
        for name, (tokens, st, counts, layer_calls, syncs, wall) in \
                runs.items():
            served.append(counts)
            gl = counts["fused_glu_split"] + counts["fused_glu_joint"]
            n_layer = sum(layer_calls.values())
            cs = sorted(layer_calls)
            emit(phase="serve_moe", arch=arch, run=name,
                 layers=cfg.num_layers,
                 reduced=[f"num_layers {full.num_layers} -> {depth}"],
                 entry="launch.serve.prune_and_pack + _serve",
                 d_model=full.d_model, moe_d_ff=full.moe_d_ff,
                 experts=full.num_experts, top_k=full.top_k,
                 shared_experts=full.num_shared_experts,
                 capacity_factor=full.capacity_factor,
                 q_heads=full.num_heads, kv_heads=full.num_kv_heads,
                 G=full.num_heads // full.num_kv_heads,
                 head_dim=full.head_dim, vocab=full.vocab_size,
                 block=[full.blast.b_in, full.blast.b_out],
                 sparsity=ARCH_SPARSITY, batch=ARCH_BATCH,
                 prompt_len=ARCH_PROMPT, new_tokens=ARCH_TOKENS,
                 tok_per_s=st["tok_per_s"], ttft_p50_s=st["ttft_p50_s"],
                 ttft_p95_s=st["ttft_p95_s"],
                 generated_tokens=st["generated_tokens"],
                 decode_slabs=st["decode_slabs"],
                 prefill_chunks=st["prefill_chunks"],
                 mixed_steps=st["mixed_steps"],
                 stalled_decode_steps=st["stalled_decode_steps"],
                 weight_bytes=memory["bytes"],
                 max_memory_allocated=max(v[1] for v in stages.values()),
                 max_memory_allocated_packing=stages["prune_and_pack"][1],
                 memory_stages=stages, **times,
                 wall_s=wall, model_calls=n_layer // depth,
                 moe_layer_calls=n_layer, launches=counts,
                 moe_launches_per_layer_call=counts["bspmm"] / n_layer,
                 capacity_by_tokens=cs,
                 C_decode=[c for t, c in cs if t == ARCH_BATCH],
                 C_prefill=[c for t, c in cs if t != ARCH_BATCH],
                 sync_calls=syncs if name == "phased_repeat" else None,
                 sync_calls_mlp_stub=stub[4] if name == "phased_repeat"
                 else None)
            check(len(tokens) == ARCH_BATCH and all(
                t.size == ARCH_TOKENS and bool(((t >= 0)
                                                & (t < full.vocab_size))
                                               .all()) for t in tokens),
                  f"{arch} {name}: a stream is short or leaves the "
                  "vocabulary")
            check(all(n % depth == 0 for n in layer_calls.values()),
                  f"{arch} {name}: MoE layer calls {layer_calls} are not "
                  f"whole model calls of {depth} layers")
            check(counts["bspmm"] == gl == n_layer * per_call,
                  f"{arch} {name}: {counts['bspmm']} bspmm and {gl} GLU "
                  f"launches over {n_layer} MoE layer calls, expected "
                  f"{per_call} each")
            for k in ("bspmm", "fused_glu_split", "paged_flash_decode"):
                check(counts[k] > 0, f"{arch} {name}: {k} never launched")
        check(all(np.array_equal(a, b) for a, b in
                  zip(runs["phased"][0], runs["phased_repeat"][0])),
              f"{arch}: the repeated phased streams differ")
        check(runs["phased_repeat"][4] == stub[4],
              f"{arch}: {runs['phased_repeat'][4]} synchronizing calls, "
              f"{stub[4]} with the MLP stubbed out")
        prompts = [rng.integers(0, full.vocab_size, size=(int(n),))
                   .astype(np.int32) for n in
                   rng.integers(ARCH_PROMPT, 2 * ARCH_PROMPT + 1,
                                size=ARCH_PARITY_PROMPTS)]
        kern = phase_moe_kernels(
            torch, card, timer, cfg, packed, joint1,
            sorted({c for run in runs.values() for _, c in run[3]}))
        emit(phase="moe_parity", arch=arch,
             **_arch_parity(torch, cfg, packed, dense, prompts))
        # serve_ep's weights leave the card (kept on an H100 until the join,
        # they left training 37.5 GB reserved where it has 17.8, and
        # train_ckpt no room beside the chaos chain); a thread writes
        # them for its ranks meanwhile
        t0 = time.monotonic()
        host = {"packed": _tree_to(packed, "cpu"),
                "joint1": _tree_to(joint1, "cpu")}
        path = os.path.join(EP_WEIGHTS, f"{arch}.pt")
        ep[arch] = dict(cfg=cfg, host=host, path=path,
                        to_host_s=time.monotonic() - t0,
                        saved=saver.submit(_save_tree, host["packed"], path),
                        full_layers=full.num_layers,
                        argv=argv, prompts=launcher._engine_prompts(
                            cfg, launcher.build_parser().parse_args(argv),
                            np.random.default_rng(0)),
                        single={k: dict(tokens=runs[k][0], calls=runs[k][3])
                                for k in ("phased", "mixed")})
        del packed, dense, joint1, kern
    saver.shutdown(wait=False)
    torch.cuda.empty_cache()
    emit(phase="serve_moe_total", seconds=time.monotonic() - t_phase)
    return served, ep


def _save_tree(tree, path):
    """``torch.save`` of ``tree`` to ``path`` under a temporary name
    first, so a reader that waits for ``path`` finds it whole. Returns
    the seconds it took."""
    import torch
    t0 = time.monotonic()
    torch.save(tree, path + ".part")
    os.replace(path + ".part", path)
    return time.monotonic() - t0

def _tree_to(tree, device):
    """A params tree (dicts, tensors, ``PackedBCSC``s) on ``device``."""
    import dataclasses as dc
    from repro_torch.core.packing import PackedBCSC
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, PackedBCSC):
        return dc.replace(tree, blocks=tree.blocks.to(device),
                          idx=tree.idx.to(device))
    return tree.to(device)


def _ep_rank(rank, world, runs):
    """One rank of ``serve_ep`` (a spawned process, gloo on card 0):
    start the group from the ``file://`` store in ``EP_DIR``; per model
    cut this rank's shard from the packed tree ``serve_moe`` saved (once
    the file is there; memory-mapped, ``shard_params`` copies only the
    rank's split leaves), move it to the card and serve through the launcher's
    ``_serve`` (its prompts, on the paged engine; its printed rows
    dropped), phased then mixed, as ``serve_moe`` did on one device. The launch counters, the MoE
    layer's calls and the collectives are reset just before and read
    just after each run. Pickles what it saw to ``rank<r>.pkl`` in
    ``EP_DIR``."""
    import io
    import pickle
    _die_with_parent()

    import torch
    import torch.distributed as tdist
    import repro_torch.launch.serve as launcher
    from repro_torch.distributed.context import (DistContext,
                                                 init_process_group,
                                                 make_mesh)
    from repro_torch.models import moe
    from repro_torch.serving import export
    torch.cuda.set_device(0)
    init_process_group(EP_DIR, rank, world, "gloo")
    coll = _count_collectives(tdist)
    out = {"rank": rank, "device": torch.cuda.current_device(), "runs": {}}
    try:
        mesh = make_mesh((1, world), ("data", "model"))
        dist = DistContext(mesh)
        for arch, r in runs.items():
            cfg = r["cfg"]
            deadline = time.monotonic() + TP_TIMEOUT_S
            while not os.path.exists(r["path"]):    # being written
                check(time.monotonic() < deadline,
                      f"serve_ep: {r['path']} was never written")
                time.sleep(0.05)
            t0 = time.monotonic()
            full = torch.load(r["path"], map_location="cpu", mmap=True,
                              weights_only=False)
            local = _tree_to(export.shard_params(cfg, full, mesh), DEVICE)
            del full
            torch.cuda.synchronize()
            a = {"shard_s": time.monotonic() - t0,
                 "weight_bytes": export.memory_report(cfg, local)["bytes"],
                 "experts_held": int(
                     local["layers"]["mlp"]["w_gate"].idx.shape[1]),
                 "expert_range": list(dist.expert_range(cfg.num_experts))}
            for name, extra in (("phased", []), ("mixed", ["--mixed"])):
                args = launcher.build_parser().parse_args(r["argv"] + extra)
                torch.cuda.synchronize()
                _reset_counts()
                moe.CALLS.clear()
                coll.clear()
                t0 = time.monotonic()
                with contextlib.redirect_stdout(io.StringIO()):
                    streams, st = launcher._serve(cfg, local, args, DEVICE,
                                                  dist=dist)
                a[name] = dict(
                    streams=streams,
                    wall_s=time.monotonic() - t0, launches=_read_counts(),
                    calls=dict(moe.CALLS),
                    collectives={k: dict(v) for k, v in coll.items()},
                    **{k: st[k] for k in (
                        "tok_per_s", "ttft_p50_s", "decode_slabs",
                        "prefill_chunks", "mixed_steps",
                        "stalled_decode_steps", "generated_tokens")})
            a["peak_bytes"] = torch.cuda.max_memory_allocated()
            del local
            torch.cuda.empty_cache()
            out["runs"][arch] = a
    finally:
        tdist.destroy_process_group()
    with open(os.path.join(EP_DIR, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _serve_ep_start(torch, ep):
    """Spawn ``serve_ep``'s ``EP_SIZE`` ranks (``_ep_rank``), gloo sharing
    card 0, each pointed at the files of ``serve_moe``'s packed trees
    (each rank waits for a file its writer has finished). They serve
    beside ``serve_ssm`` and ``serve_audio_vlm``."""
    runs = {a: {k: e[k] for k in ("cfg", "path", "argv")}
            for a, e in ep.items()}
    return _start_ranks(EP_DIR, _ep_rank, EP_SIZE, (EP_SIZE, runs))


def phase_serve_ep(torch, card, ep, procs):
    """Expert parallelism on the card (``dist=`` on the MoE family, the
    reference's ``_moe_shardmap``): ``serve_moe``'s two full-width packed
    models served by ``EP_SIZE`` ranks over gloo on one card (which
    measures no expert-parallel speed and claims none), each holding the
    experts ``DistContext.expert_range`` names, with attention
    tensor-parallel and the router and shared experts whole.

    Holds, per model and rank: E/``EP_SIZE`` experts held; the phased and
    mixed engine runs' streams equal the single-device runs' of
    ``serve_moe``, call for call (the MoE layer calls by (tokens, C)
    equal: capacity follows each call's tokens), a first divergence only
    where the single-device top-2 margin is below ``TP_NEAR_TIE`` times
    2**-5 of the logits' magnitude (``_near_tie_equal``); both ranks'
    streams equal (the engine's lockstep digest check ran at the end of
    each run); the expert-batched ``bspmm`` and fused GLU launched once
    per MoE layer call (twice with deepseek's shared experts) and paged
    decode launched; one all-reduce per MoE layer and per attention in
    every model call, plus the embedding's; the weight bytes at most
    ``TP_BYTES_FRACTION`` of one device's plus the leaves every rank
    holds whole. Then the expert-batched kernels at rank 1's
    E/``EP_SIZE`` experts of layer 0, at every C the runs used, each held
    against its plain version (``ep_kernel`` lines). Returns the ranks'
    launch counts."""
    from repro_torch.distributed.context import Mesh
    from repro_torch.serving import export
    t_phase = time.monotonic()
    ranks = _join_ranks("serve_ep", EP_DIR, procs)
    timer = Timer(torch)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 28)
    counts = []
    world = len(ranks)
    mesh1 = Mesh(("data", "model"), (1, world), 1)
    for arch, e in ep.items():
        cfg = e["cfg"]
        t0 = time.monotonic()
        packed = _tree_to(e["host"]["packed"], DEVICE)
        joint1 = _tree_to(e["host"]["joint1"], DEVICE)
        torch.cuda.synchronize()
        to_card_s = time.monotonic() - t0
        e_l = cfg.num_experts // world
        full_bytes = export.memory_report(cfg, packed)["bytes"]
        whole = _whole_bytes(cfg, packed, mesh1)
        mag = float(_last_logits(torch, cfg, packed, e["prompts"][0])
                    .abs().max())
        near_tie = TP_NEAR_TIE * 2.0 ** -5 * mag
        per_call = 1 + bool(cfg.num_shared_experts)
        runs = {}
        for name in ("phased", "mixed"):
            want = e["single"][name]
            r0 = ranks[0]["runs"][arch][name]
            accepted = _near_tie_equal(
                torch, cfg, packed, e["prompts"],
                dict(enumerate(r0["streams"])),
                dict(enumerate(want["tokens"])),
                f"serve_ep {arch} {name}", tol=near_tie)
            per_rank = []
            for r in ranks:
                got = r["runs"][arch][name]
                for a, b in zip(got["streams"], r0["streams"]):
                    check(np.array_equal(a, b), f"serve_ep {arch} {name}: "
                          f"rank {r['rank']}'s streams differ from rank 0's")
                check(got["calls"] == want["calls"],
                      f"serve_ep {arch} {name}: rank {r['rank']}'s MoE "
                      f"layer calls {got['calls']} are not one device's "
                      f"{want['calls']}")
                n_layer = sum(got["calls"].values())
                model_calls = n_layer // cfg.num_layers
                lc = got["launches"]
                gl = lc["fused_glu_split"] + lc["fused_glu_joint"]
                check(lc["bspmm"] == gl == n_layer * per_call,
                      f"serve_ep {arch} {name}: {lc['bspmm']} bspmm and {gl} "
                      f"GLU launches over {n_layer} MoE layer calls")
                check(lc["paged_flash_decode"] > 0,
                      f"serve_ep {arch} {name}: paged decode never launched")
                ar = sum(got["collectives"].get("all_reduce", {}).values())
                check(ar == model_calls * (2 * cfg.num_layers + 1),
                      f"serve_ep {arch} {name}: {ar} all-reduces over "
                      f"{model_calls} model calls")
                counts.append(lc)
                per_rank.append(dict(
                    launches=lc, collectives=got["collectives"],
                    tok_per_s=got["tok_per_s"], wall_s=got["wall_s"]))
            runs[name] = dict(
                accepted_divergences=accepted, moe_layer_calls=n_layer,
                model_calls=model_calls,
                capacity_by_tokens=sorted(want["calls"]),
                expert_launches_per_layer_call=lc["bspmm"] / n_layer,
                all_reduces_per_model_call=ar / model_calls,
                ranks=per_rank,
                **{k: r0[k] for k in ("ttft_p50_s", "decode_slabs",
                                      "prefill_chunks", "mixed_steps",
                                      "stalled_decode_steps",
                                      "generated_tokens")})
        for r in ranks:
            a = r["runs"][arch]
            check(a["experts_held"] == e_l,
                  f"serve_ep {arch}: rank {r['rank']} holds "
                  f"{a['experts_held']} experts, not {e_l}")
            check(a["weight_bytes"] <= TP_BYTES_FRACTION * full_bytes + whole,
                  f"serve_ep {arch}: rank {r['rank']} holds "
                  f"{a['weight_bytes']} of {full_bytes} bytes")
        caps = sorted({c for name in runs
                       for _, c in runs[name]["capacity_by_tokens"]})
        mlp1 = _mlp_of(cfg, export.shard_params(
            cfg, _first_layers(packed, 1), mesh1), 0)
        jm1 = _mlp_of(cfg, export.shard_params(cfg, joint1, mesh1), 0)
        lines = {c: _mlp_lines(torch, card, timer, gen, "ep_kernel", (e_l,),
                               c, mlp1["w_down"], mlp1["w_gate"],
                               mlp1["w_up"], jm1["w_gate"], jm1["w_up"],
                               cfg.mlp_act, C=c, experts=e_l, rank=1,
                               arch=arch, ep=world)
                 for c in caps}
        emit(phase="serve_ep", arch=arch, layers=cfg.num_layers,
             reduced=[f"num_layers {e['full_layers']} -> "
                      f"{cfg.num_layers}"],
             ep=world, backend="gloo", devices=[r["device"] for r in ranks],
             experts=cfg.num_experts, experts_per_rank=e_l,
             expert_ranges=[r["runs"][arch]["expert_range"] for r in ranks],
             shared_experts=cfg.num_shared_experts,
             streams_equal_single_device=True, rank_streams_equal=True,
             near_tie=near_tie, runs=runs,
             weight_bytes_per_rank=[r["runs"][arch]["weight_bytes"]
                                    for r in ranks],
             weight_share_per_rank=[r["runs"][arch]["weight_bytes"]
                                    / full_bytes for r in ranks],
             single_device_weight_bytes=full_bytes, whole_leaf_bytes=whole,
             shard_s=[r["runs"][arch]["shard_s"] for r in ranks],
             to_host_s=e["to_host_s"], save_s=e["saved"].result(),
             to_card_s=to_card_s,
             peak_bytes_per_rank=[r["runs"][arch]["peak_bytes"]
                                  for r in ranks],
             kernel_lines={c: {k: {"ms": v["ms"],
                                   "max_abs_err": v["max_abs_err"]}
                               for k, v in ln.items()}
                           for c, ln in lines.items()},
             tok_per_s_note="two ranks on one card over gloo: the phase's "
                            "own rate, not an expert-parallel speed")
        del mlp1, jm1, packed, joint1
        torch.cuda.empty_cache()
    ep.clear()
    shutil.rmtree(EP_WEIGHTS)
    emit(phase="serve_ep_total", seconds=time.monotonic() - t_phase)
    return counts


# ------------------------------------------------ the recurrent families
def _bspmm_line(torch, card, timer, gen, phase, p, m, **base):
    """``bspmm`` of ``m`` bf16 rows against one pack, held against its
    plain version within ``ulp_tol``; the library yardstick is
    ``torch.matmul`` on the dense weight. Bytes count every packed block
    and idx entry once, X and Y once."""
    from repro_torch.kernels import bspmm as kb, ops
    dt, es = torch.bfloat16, 2
    x = torch.randn(m, p.kb * p.b_in, generator=gen, device=DEVICE).to(dt)
    w = _dense_of(torch, p)
    k_fn = lambda: kb.bspmm(x, p)  # noqa: E731
    p_fn = lambda: ops.bspmm_plain(x, p)  # noqa: E731
    l_fn = lambda: torch.matmul(x, w)  # noqa: E731
    nbytes = (x.numel() * es + p.blocks.numel() * es + p.idx.numel() * 4
              + m * p.nb * p.b_out * es)
    return _record(
        torch, card, phase, "bspmm", dt, [m], k_fn(), p_fn(),
        timer.ms(k_fn), timer.ms(p_fn), timer.ms(l_fn), nbytes,
        ops.flops_bspmm(m, p), plan=kb.launch_plan(x, p).describe(),
        kb=p.kb, nb=p.nb, nnz=p.nnz, block=[p.b_in, p.b_out], **base)


def _ssm_scan(torch, cfg2, params):
    """``registry.forward`` (chunked: one chunk of ``SSM_SCAN_S``) against
    ``SSM_SCAN_S`` ``decode_step``s on the same tokens, in f32 with an f32
    cache: the reference's decode-consistency check on the card."""
    from repro_torch.models import registry
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    toks = torch.randint(0, cfg2.vocab_size, (SSM_SCAN_B, SSM_SCAN_S),
                         generator=gen, device=DEVICE)
    with torch.inference_mode():
        full, _ = registry.forward(cfg2, params, toks)
        cache = registry.init_cache(cfg2, SSM_SCAN_B, SSM_SCAN_S,
                                    dtype=torch.float32, device=DEVICE)
        steps = []
        for t in range(SSM_SCAN_S):
            lg, cache = registry.decode_step(cfg2, params, cache,
                                             toks[:, t:t + 1], t)
            steps.append(lg[:, 0])
    got = torch.stack(steps, dim=1)
    check(bool(torch.isfinite(full).all() and torch.isfinite(got).all()),
          f"{cfg2.name}: non-finite scan logits")
    tol = SSM_LOGIT_TOL * float(full.abs().max())
    err = float((got - full).abs().max())
    check(err <= tol, f"{cfg2.name}: decode vs chunked forward differ by "
                      f"{err} > {tol}")
    return {"lanes": SSM_SCAN_B, "tokens": SSM_SCAN_S,
            "chunk": cfg2.chunk_size, "max_abs_err": err, "tol": tol,
            "err_over_tol": err / tol}


def _ssm_parity(torch, cfg2, packed, dense):
    """On a two-layer cut in f32: on the inputs the pruned-dense model
    feeds each sparse MLP (rwkv6's channel-mix ``mlp2``, zamba's shared
    GLU, recorded from a chunked forward of 4 x 64 tokens), the packed MLP
    (``bspmm``, the fused GLU) against the dense one within ``ulp_tol``'s
    f32 1e-4 of the output's magnitude; then every position's logits
    within ``SSM_LOGIT_TOL`` of theirs."""
    from repro_torch.core import sparse_mlp as sm
    from repro_torch.models import registry, transformer
    name = "mlp2" if cfg2.family == "ssm" else "glu_mlp"
    orig = getattr(sm, name)
    seen = []

    def recording(x, *a, **kw):
        seen.append(x.clone())
        return orig(x, *a, **kw)

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    toks = torch.randint(0, cfg2.vocab_size, (4, SSM_SCAN_S),
                         generator=gen, device=DEVICE)
    worst = {"mlp": 0.0, "logits": 0.0}

    def hold(kind, got, want, rel, where):
        check(bool(torch.isfinite(got).all()),
              f"{cfg2.name}: non-finite packed {where}")
        tol = rel * float(want.abs().max())
        err = float((got.float() - want.float()).abs().max())
        worst[kind] = max(worst[kind], err / tol)
        check(err <= tol, f"{cfg2.name} {where}: packed vs dense differ by "
                          f"{err} > {tol}")

    with torch.inference_mode():
        setattr(sm, name, recording)
        try:
            want, _ = registry.forward(cfg2, dense, toks)
        finally:
            setattr(sm, name, orig)
        got, _ = registry.forward(cfg2, packed, toks)
        for i, x in enumerate(seen):   # one call per layer or application
            if cfg2.family == "ssm":
                pm, dm = (transformer._layer_view(t["layers"], i)["mlp"]
                          for t in (packed, dense))
                y_p, y_d = (sm.mlp2(x, t["w_in"], t["w_out"], act="relu",
                                    square=True) for t in (pm, dm))
            else:
                y_p, y_d = (sm.glu_mlp(x, t["w_gate"], t["w_up"],
                                       t["w_down"], act=cfg2.mlp_act)
                            for t in (packed["shared"]["mlp"],
                                      dense["shared"]["mlp"]))
            hold("mlp", y_p, y_d, 1e-4, f"MLP call {i}")
        hold("logits", got, want, SSM_LOGIT_TOL, "logits")
    return {"depth": cfg2.num_layers, "prompts": toks.shape[0],
            "tokens": toks.shape[1], "mlps_checked": len(seen),
            "mlp_max_err_over_tol": worst["mlp"],
            "logits_max_err_over_tol": worst["logits"],
            "mlp_tol_fraction": 1e-4, "logits_tol_fraction": SSM_LOGIT_TOL}


def _launcher_run(torch, arch, keep=None):
    """``launch.serve.main`` on ``arch`` whole (the one-shot prune at s =
    0.8, packed; the launcher's 8 prompts of 64 tokens x 32 new), the
    launch counters reset just before and read just after. Peak device
    memory is read through init, prune and pack (the f32 params
    included) and, from the start of serving (``main`` has dropped the
    f32 params by then), through serving, beside what serving started
    from. With ``keep`` (a dict) the packed tree is kept there under
    "packed". Returns (main's summary, launches, peaks, wall seconds)."""
    import repro_torch.launch.serve as launcher
    argv = ["--arch", arch, "--packed", "--batch", str(ARCH_BATCH),
            "--prompt-len", str(ARCH_PROMPT), "--new-tokens",
            str(ARCH_TOKENS)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    peaks = {}
    pack, serve = launcher.prune_and_pack, launcher._serve

    def packing(*a, **kw):
        out = pack(*a, **kw)
        torch.cuda.synchronize()
        peaks["packing"] = torch.cuda.max_memory_allocated()
        if keep is not None:
            keep["packed"] = out
        return out

    def serving(*a, **kw):
        torch.cuda.synchronize()
        peaks["serving_from"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return serve(*a, **kw)

    t0 = time.monotonic()
    launcher.prune_and_pack, launcher._serve = packing, serving
    _reset_counts()
    try:
        res = launcher.main(argv)
    finally:
        launcher.prune_and_pack, launcher._serve = pack, serve
    counts = _read_counts()
    wall = time.monotonic() - t0
    peaks["serving"] = torch.cuda.max_memory_allocated()
    return res, counts, peaks, wall


def phase_serve_ssm(torch, card):
    """The recurrent families (``models/rwkv6.py``, ``models/zamba.py``
    over ``models/linear_scan.py``) whole, at full width and depth,
    through ``launch.serve.main`` (the launcher's one-shot prune at s =
    0.8, packed; 8 prompts of 64 tokens x 32 new through
    ``serve_loop.generate``, token-by-token prefill into the per-lane
    recurrent state), the launch counters reset just before and read just
    after (``_launcher_run``, with the peaks while packing and while
    serving): ``bspmm`` must launch for both (rwkv6's channel-mix,
    zamba's shared down projection) and the split fused GLU for zamba.
    Then, on a fresh two-layer cut of each: the kernel lines of layer 0
    at M = 8 bf16 rows (rwkv6: ``bspmm`` on ``w_in``'s 128 x 16
    and ``w_out``'s 16 x 128 blocks; zamba: the split and joint GLU and
    ``bspmm`` on the unstacked shared MLP), the chunked forward against
    the decode steps (``ssm_scan``) and the packed export against the
    pruned-dense one (``ssm_parity``). Each model also runs
    ``serve_ssm_tp``'s short traffic on one device (its ranks' oracle,
    ``_ssm_short``) and hands its packed tree to them. Returns (the
    serving runs' counts, the hand-offs by arch)."""
    import repro_torch.launch.serve as launcher
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models import transformer
    t_phase = time.monotonic()
    timer = Timer(torch)
    served, ssmtp = [], {}
    saver = concurrent.futures.ThreadPoolExecutor(1)
    for arch in SSM_RUNS:
        full = get_config(arch)
        keep = {}
        res, counts, peaks, wall = _launcher_run(torch, arch, keep)
        served.append(counts)
        # serve_ssm_tp's oracle: one device's run of its short traffic
        # in the served pass's dtype, then the packed tree handed to its
        # ranks
        short = np.random.default_rng(SEED + 31).integers(
            0, full.vocab_size, (ARCH_BATCH, TP_AV_PROMPT)).astype(np.int32)
        f32 = dataclasses.replace(full, compute_dtype="float32")
        served_cfg = dataclasses.replace(
            full, compute_dtype=SSM_TP_PASSES[arch]["served"])
        _reset_counts()
        toks, st = _ssm_short(torch, served_cfg, keep["packed"], short)
        served.append(_read_counts())
        drift = _bf16_drift(torch, full, f32, keep["packed"], short)
        ssmtp[arch] = _tp_av_handoff(
            torch, served_cfg, keep.pop("packed"), {"prompts": short}, saver,
            directory=SSM_TP_WEIGHTS, streams=toks,
            single_tok_per_s=st["tok_per_s"], bf16_drift=drift)
        tokens, stats = res["tokens"], res["stats"]
        emit(phase="serve_ssm", arch=arch, family=full.family,
             layers=full.num_layers, reduced=None,
             entry="launch.serve.main -> serve_loop.generate",
             d_model=full.d_model, d_ff=full.d_ff, vocab=full.vocab_size,
             heads=full.num_heads, pad_heads_to=full.pad_heads_to,
             head_dim=full.head_dim, ssm_heads=full.ssm_heads,
             ssm_state=full.ssm_state, attn_every=full.attn_every,
             block=[full.blast.b_in, full.blast.b_out], act=full.mlp_act,
             sparsity=ARCH_SPARSITY, batch=ARCH_BATCH,
             prompt_len=ARCH_PROMPT, new_tokens=ARCH_TOKENS,
             tok_per_s=stats["tok_per_s"], decode_s=stats["decode_s"],
             weight_bytes=res["memory"]["bytes"],
             max_memory_allocated_packing=peaks["packing"],
             max_memory_allocated_serving=peaks["serving"],
             allocated_serving_start=peaks["serving_from"],
             **res["seconds"], wall_s=wall, launches=counts)
        check(len(tokens) == ARCH_BATCH and all(
            t.size == ARCH_TOKENS and bool(((t >= 0)
                                            & (t < full.vocab_size)).all())
            for t in tokens), f"{arch}: a stream is short or leaves the "
                              "vocabulary")
        must = ("bspmm",) + (("fused_glu_split",) if full.family == "hybrid"
                             else ())
        for k in must:
            check(counts[k] > 0, f"{arch}: kernel {k} never launched")
        del res, tokens

        # a two-layer cut: the kernel lines, the scan and the parity
        cfg2 = dataclasses.replace(full, num_layers=PARITY_DEPTH)
        params = registry.init_params(cfg2, SEED, DEVICE)
        masks = launcher.one_shot_masks(cfg2, params, ARCH_SPARSITY)
        packed = launcher.prune_and_pack(cfg2, params, ARCH_SPARSITY, True,
                                         masks=masks)
        dense = launcher.prune_and_pack(cfg2, params, ARCH_SPARSITY, False,
                                        masks=masks)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
        base = dict(arch=arch)
        if full.family == "ssm":
            mlp0 = transformer._layer_view(packed["layers"], 0)["mlp"]
            kern = {w: _bspmm_line(torch, card, timer, gen, "ssm_kernel",
                                   mlp0[w], ARCH_M, weight=w, **base)
                    for w in ("w_in", "w_out")}
        else:
            joint = launcher.prune_and_pack(
                cfg2, params, ARCH_SPARSITY, True,
                masks={k: masks[k.replace("w_up", "w_gate")]
                       for k in masks})
            jm, m0 = joint["shared"]["mlp"], packed["shared"]["mlp"]
            check(jm["w_gate"].joint and not m0["w_gate"].joint
                  and m0["w_gate"].idx.dim() == 2,
                  f"{arch}: the shared GLU's pack or joint marking is wrong")
            kern = _mlp_lines(torch, card, timer, gen, "ssm_kernel", (),
                              ARCH_M, m0["w_down"], m0["w_gate"],
                              m0["w_up"], jm["w_gate"], jm["w_up"],
                              full.mlp_act, block=[full.blast.b_in,
                                                   full.blast.b_out], **base)
            del joint, jm
        f32 = dataclasses.replace(cfg2, compute_dtype="float32")
        emit(phase="ssm_scan", arch=arch, depth=PARITY_DEPTH,
             **_ssm_scan(torch, f32, params))
        emit(phase="ssm_parity", arch=arch,
             **_ssm_parity(torch, f32, packed, dense),
             kernels={k: {f: v[f] for f in ("ms", "bound_ms", "library_ms")}
                      for k, v in kern.items()})
        del params, masks, packed, dense, kern
    torch.cuda.empty_cache()
    saver.shutdown(wait=False)
    emit(phase="serve_ssm_total", seconds=time.monotonic() - t_phase)
    return served, ssmtp


def _whisper_serve(torch, full, saver):
    """whisper-large-v3 whole: seeded f32 init, the launcher's one-shot
    prune at s = 0.8 packed (``launch.serve.prune_and_pack``), then
    ``serve_loop.generate(frames=)``: ``ARCH_BATCH`` lanes of
    ``AUDIO_FRAMES`` frames through the encoder once (``prefill_cross``,
    timed apart), the 64-token prompts prefilled token by token, 32 new
    tokens. The launch counters are reset just before serving and read
    just after. Returns (the line's fields, launches)."""
    import repro_torch.launch.serve as launcher
    from repro_torch.models import attention, registry, whisper
    from repro_torch.serving import export, serve_loop
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = registry.init_params(full, SEED, DEVICE)
    torch.cuda.synchronize()
    times = {"init_s": time.monotonic() - t0}
    packed = launcher.prune_and_pack(full, params, ARCH_SPARSITY, True,
                                     times=times)
    peak_packing = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    frames = torch.randn(ARCH_BATCH, AUDIO_FRAMES, full.d_model,
                         generator=gen, device=DEVICE) * 0.02
    prompts = np.random.default_rng(SEED + 9).integers(
        0, full.vocab_size, (ARCH_BATCH, ARCH_PROMPT)).astype(np.int32)
    enc = {}
    cross = whisper.prefill_cross

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.monotonic()
        ck, cv = cross(*a, **kw)
        torch.cuda.synchronize()
        enc.update(encoder_s=time.monotonic() - t, cross_cache_shape=list(
            ck.shape), cross_cache_bytes=2 * ck.numel() * ck.element_size())
        return ck, cv

    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    whisper.prefill_cross = timed
    _reset_counts()
    t0 = time.monotonic()
    try:
        toks, stats = serve_loop.generate(
            full, packed, prompts, max_new_tokens=ARCH_TOKENS,
            frames=frames, device=DEVICE)
    finally:
        whisper.prefill_cross = cross
    counts = _read_counts()
    wall = time.monotonic() - t0
    peak_serving = torch.cuda.max_memory_allocated()
    gen_toks = toks[:, ARCH_PROMPT:]
    check(toks.shape == (ARCH_BATCH, ARCH_PROMPT + ARCH_TOKENS)
          and bool(((gen_toks >= 0) & (gen_toks < full.vocab_size)).all()),
          "whisper: a stream is short or leaves the vocabulary")
    _, kv = attention.eff_heads(full)
    want_bytes = (2 * full.num_layers * ARCH_BATCH * AUDIO_FRAMES * kv
                  * full.head_dim * 2)
    check(enc.get("cross_cache_bytes") == want_bytes,
          f"whisper: cross cache {enc} != {want_bytes} bytes")
    steps = ARCH_PROMPT + ARCH_TOKENS - 1
    want_bspmm = 2 * (full.num_encoder_layers + full.num_layers * steps)
    check(counts["bspmm"] == want_bspmm,
          f"whisper: {counts['bspmm']} bspmm launches, {want_bspmm} "
          "expected (2 a layer: the encoder once, the decoder each step)")
    for k in ("fused_glu_split", "fused_glu_joint", "paged_flash_decode",
              "bspmm_t"):
        check(counts[k] == 0, f"whisper: kernel {k} launched")
    # serve_tp_av's oracle: one device on the ranks' short traffic (each
    # prompt's first TP_AV_PROMPT tokens, the same frames)
    short = np.ascontiguousarray(prompts[:, :TP_AV_PROMPT])
    _reset_counts()
    t0 = time.monotonic()
    s_toks, s_last, _ = _whisper_short(torch, full, packed, short, frames)
    s_wall = time.monotonic() - t0
    short_counts = _read_counts()
    line = dict(
        entry="prune_and_pack -> serve_loop.generate(frames=)",
        encoder_layers=full.num_encoder_layers, frames=AUDIO_FRAMES,
        tok_per_s=stats["tok_per_s"], decode_s=stats["decode_s"],
        prompt_prefill_s=wall - enc["encoder_s"] - stats["decode_s"],
        weight_bytes=export.memory_report(full, packed)["bytes"],
        max_memory_allocated_packing=peak_packing,
        max_memory_allocated_serving=peak_serving,
        allocated_serving_start=start, **times, **enc, wall_s=wall,
        tp_av_single_wall_s=s_wall)
    handoff = _tp_av_handoff(
        torch, full, packed, {"frames": frames.cpu(), "prompts": short},
        saver, streams=s_toks, logits=s_last[:4], single_counts=short_counts,
        cross_cache_bytes=enc["cross_cache_bytes"])
    del packed, toks
    return line, counts, handoff


def _whisper_short(torch, cfg, params, prompts, frames, dist=None):
    """``serve_loop.generate(frames=)`` of ``TP_AV_TOKENS`` new tokens on
    ``prompts``, keeping the prefill's last-token logits (the vocab
    shards gathered under ``dist``; the gather is collective). Returns
    (generated tokens (B, TP_AV_TOKENS), those logits (B, V) f32 on the
    host, the stats)."""
    from repro_torch.serving import serve_loop
    seen, orig = {}, serve_loop._prefill

    def keep(*a, **kw):
        out = orig(*a, **kw)          # (the rows' last logits, cache, ...)
        whole = (dist.all_gather(out[0], dim=-1) if dist is not None
                 and dist.shards(cfg.vocab_size) else out[0])
        seen["last"] = whole.float().cpu()
        return out

    serve_loop._prefill = keep
    try:
        toks, st = serve_loop.generate(
            cfg, params, prompts, max_new_tokens=TP_AV_TOKENS,
            frames=frames, device=DEVICE, dist=dist)
    finally:
        serve_loop._prefill = orig
    return toks[:, prompts.shape[1]:], seen["last"], st


def _tp_av_engine(torch, cfg, params, prompts, dist=None):
    """``serve_tp_av``'s engine runs of ``prompts`` (``TP_AV_TOKENS`` new
    tokens each, ``TP_AV_ENGINE``), phased then mixed, the launch
    counters reset just before and read just after each. -> {mode:
    streams, lockstep digest, KV pool bytes, launches, stats}."""
    from repro_torch.serving.engine import Engine
    out = {}
    for name, mode in (("phased", {}), ("mixed", {"mixed": True})):
        _reset_counts()
        eng = Engine(cfg, params, device=DEVICE, dist=dist, **TP_AV_ENGINE,
                     **mode)
        uids = [eng.submit(p, TP_AV_TOKENS) for p in prompts]
        t0 = time.monotonic()
        res = eng.run()
        out[name] = dict(
            streams=[res[u].generated for u in uids],
            ok=all(res[u].ok for u in uids), wall_s=time.monotonic() - t0,
            digest=eng.lockstep_digest, launches=_read_counts(),
            kv_pool_bytes=sum(t.numel() * t.element_size()
                              for t in eng.cache.values()),
            **{k: eng.stats[k] for k in (
                "tok_per_s", "stalled_decode_steps", "mixed_steps",
                "decode_slabs", "prefill_chunks")})
        del eng
    return out


def _tp_av_handoff(torch, cfg, packed, inputs, saver,
                   directory=TP_AV_WEIGHTS, **single):
    """Hand one packed tree to ``serve_tp_av``'s ranks (or those whose
    files are in ``directory``): a host copy (the card's copy is the
    caller's to free), written with the ranks' inputs to
    ``<directory>/<name>.pt`` by ``saver``'s thread while the script goes
    on. Returns what the join needs (``single``: the one-device
    readings)."""
    t0 = time.monotonic()
    host = _tree_to(packed, "cpu")
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{cfg.name}.pt")
    return dict(cfg=cfg, host=host, inputs=inputs,
                to_host_s=time.monotonic() - t0,
                saved=saver.submit(
                    _save_tree, {"params": host, "inputs": inputs}, path),
                **single)


def _av_parity(torch, card, timer, full):
    """On a two-layer cut of ``full`` (two encoder and two decoder layers
    for whisper) at full width: whisper's kernel lines (``bspmm`` on
    encoder layer 0's ``w_in`` and ``w_out`` at M = ARCH_BATCH x
    AUDIO_FRAMES rows, the encoder's call, and on decoder layer 0's at
    M = ARCH_M, a decode step's), then in f32 the packed export against
    the pruned-dense one: every sparse MLP call on the inputs the dense
    model feeds it within 1e-4 of its magnitude, and the logits of
    ``forward(frames=)`` / ``forward(patch_embeds=)`` within
    ``SSM_LOGIT_TOL``; whisper's teacher-forced ``decode_step``s over
    ``prefill_cross`` against its forward, and the patches moving every
    position of the VLM's logits."""
    import repro_torch.launch.serve as launcher
    from repro_torch.core import sparse_mlp as sm
    from repro_torch.models import registry, transformer, whisper
    audio = full.family == "audio"
    cfg2 = dataclasses.replace(full, num_layers=PARITY_DEPTH,
                               num_encoder_layers=min(
                                   full.num_encoder_layers, PARITY_DEPTH))
    params = registry.init_params(cfg2, SEED, DEVICE)
    masks = launcher.one_shot_masks(cfg2, params, ARCH_SPARSITY)
    packed = launcher.prune_and_pack(cfg2, params, ARCH_SPARSITY, True,
                                     masks=masks)
    dense = launcher.prune_and_pack(cfg2, params, ARCH_SPARSITY, False,
                                    masks=masks)
    del params, masks
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    kern = {}
    if audio:
        for stack, m in (("encoder", ARCH_BATCH * AUDIO_FRAMES),
                         ("decoder", ARCH_M)):
            mlp0 = transformer._layer_view(packed[stack], 0)["mlp"]
            for w in ("w_in", "w_out"):
                kern[f"{stack}/{w}"] = _bspmm_line(
                    torch, card, timer, gen, "audio_kernel", mlp0[w], m,
                    arch=full.name, weight=f"{stack}/mlp/{w}")
    f32 = dataclasses.replace(cfg2, compute_dtype="float32")
    b, t = AV_PARITY_B, AV_PARITY_TOKENS
    if audio:
        extra = {"frames": torch.randn(b, AUDIO_FRAMES, full.d_model,
                                       generator=gen, device=DEVICE) * 0.02}
        calls = [(s, i) for s in ("encoder", "decoder")
                 for i in range(PARITY_DEPTH)]
        name = "mlp2"
    else:
        extra = {"patch_embeds": torch.randn(
            b, full.num_patches, full.d_model, generator=gen,
            device=DEVICE) * 0.02}
        t += full.num_patches
        calls = [("layers", i) for i in range(PARITY_DEPTH)]
        name = "glu_mlp"
    toks = torch.randint(0, full.vocab_size, (b, t), generator=gen,
                         device=DEVICE)
    orig, seen = getattr(sm, name), []

    def recording(x, *a, **kw):
        seen.append(x.clone())
        return orig(x, *a, **kw)

    worst = {}

    def hold(kind, got, want, rel, where):
        check(bool(torch.isfinite(got).all()),
              f"{full.name}: non-finite {where}")
        tol = rel * float(want.abs().max())
        err = float((got.float() - want.float()).abs().max())
        worst[kind] = max(worst.get(kind, 0.0), err / tol)
        check(err <= tol, f"{full.name} {where}: {err} > {tol}")

    def mlp(p, x):
        if audio:
            return sm.mlp2(x, p["w_in"], p["w_out"], p["b_in"], p["b_out"],
                           act=full.mlp_act)
        return sm.glu_mlp(x, p["w_gate"], p["w_up"], p["w_down"],
                          act=full.mlp_act)

    with torch.inference_mode():
        setattr(sm, name, recording)
        try:
            want, _ = registry.forward(f32, dense, toks, **extra)
        finally:
            setattr(sm, name, orig)
        got, _ = registry.forward(f32, packed, toks, **extra)
        check(len(seen) == len(calls), f"{full.name}: {len(seen)} MLP "
                                       f"calls, {len(calls)} expected")
        for (stack, i), x in zip(calls, seen):
            views = [transformer._layer_view(tr[stack], i)["mlp"]
                     for tr in (packed, dense)]
            hold("mlp", mlp(views[0], x), mlp(views[1], x), 1e-4,
                 f"{stack} layer {i} MLP")
        hold("logits", got, want, SSM_LOGIT_TOL, "logits")
        if audio:
            cache = registry.init_cache(f32, b, t, dtype=torch.float32,
                                        device=DEVICE)
            cache["ck"], cache["cv"] = whisper.prefill_cross(
                f32, packed, extra["frames"], dtype=torch.float32)
            steps = []
            for j in range(t):
                lg, cache = registry.decode_step(f32, packed, cache,
                                                 toks[:, j:j + 1], j)
                steps.append(lg[:, 0])
            hold("decode", torch.stack(steps, dim=1), got, SSM_LOGIT_TOL,
                 "decode vs forward")
            del cache
        else:
            text, _ = registry.forward(f32, packed, toks)
            moved = (got - text).abs().amax(dim=-1)
            worst["patch_move_min_over_magnitude"] = float(
                moved.min()) / float(text.abs().max())
            check(bool((moved > 1e-3 * text.abs().max()).all()),
                  f"{full.name}: the patches leave a position's logits")
    return dict(depth=PARITY_DEPTH, encoder_depth=cfg2.num_encoder_layers,
                lanes=b, tokens=t, mlps_checked=len(seen),
                **{f"{k}_max_err_over_tol" if k in ("mlp", "logits",
                                                    "decode") else k: v
                   for k, v in worst.items()},
                mlp_tol_fraction=1e-4, logits_tol_fraction=SSM_LOGIT_TOL), \
        kern


def phase_serve_audio_vlm(torch, card):
    """The last two families whole, at full width and depth: whisper-large-v3
    (``models/whisper.py``: 32 encoder and 32 decoder layers, heads padded
    20 -> 32) through ``_whisper_serve`` (``bspmm`` must launch, exactly
    twice per layer call, and no GLU, paged decode or ``bspmm_t``), and
    internvl2-2b (the transformer with patch embeddings; the engine
    serves text) through ``launch.serve.main`` (``_launcher_run``:
    ``bspmm``, the split GLU and paged decode must launch). Then each on
    a two-layer cut (``_av_parity``): whisper's ``audio_kernel`` lines at
    M = 12000 and 8, and the packed-vs-dense parities. Each model also
    runs ``serve_tp_av``'s short traffic on one device (the oracle of its
    ranks) and hands its packed tree to them (``_tp_av_handoff``).
    Returns (the serving runs' counts, the hand-offs by arch)."""
    from repro_torch.configs import get_config
    t_phase = time.monotonic()
    timer = Timer(torch)
    served, tpav = [], {}
    saver = concurrent.futures.ThreadPoolExecutor(1)
    for arch in AUDIO_VLM_RUNS:
        full = get_config(arch)
        if full.family == "audio":
            line, counts, tpav[arch] = _whisper_serve(torch, full, saver)
            served.append(tpav[arch]["single_counts"])
        else:
            keep = {}
            res, counts, peaks, wall = _launcher_run(torch, arch, keep)
            # serve_tp_av's oracle: one device's engine runs of its traffic
            short = [p for p in np.random.default_rng(SEED + 29).integers(
                0, full.vocab_size, (ARCH_BATCH, TP_AV_PROMPT)).astype(
                    np.int32)]
            single = _tp_av_engine(torch, full, keep["packed"], short)
            served += [r["launches"] for r in single.values()]
            tpav[arch] = _tp_av_handoff(torch, full, keep.pop("packed"),
                                        {"prompts": short}, saver,
                                        single=single)
            toks = res["tokens"]
            check(len(toks) == ARCH_BATCH and all(
                x.size == ARCH_TOKENS
                and bool(((x >= 0) & (x < full.vocab_size)).all())
                for x in toks), f"{arch}: a stream is short or leaves "
                                "the vocabulary")
            for k in PAGED:
                check(counts[k] > 0, f"{arch}: kernel {k} never launched")
            line = dict(entry="launch.serve.main -> engine (paged)",
                        tok_per_s=res["stats"]["tok_per_s"],
                        ttft_p50_s=res["stats"]["ttft_p50_s"],
                        weight_bytes=res["memory"]["bytes"],
                        max_memory_allocated_packing=peaks["packing"],
                        max_memory_allocated_serving=peaks["serving"],
                        allocated_serving_start=peaks["serving_from"],
                        **res["seconds"], wall_s=wall)
            del res, toks
        served.append(counts)
        emit(phase="serve_audio_vlm", arch=arch, family=full.family,
             layers=full.num_layers, reduced=None, d_model=full.d_model,
             d_ff=full.d_ff, vocab=full.vocab_size, heads=full.num_heads,
             kv_heads=full.num_kv_heads, pad_heads_to=full.pad_heads_to,
             head_dim=full.head_dim,
             block=[full.blast.b_in, full.blast.b_out], act=full.mlp_act,
             sparsity=ARCH_SPARSITY, batch=ARCH_BATCH,
             prompt_len=ARCH_PROMPT, new_tokens=ARCH_TOKENS, **line,
             launches=counts)
        gc.collect()
        torch.cuda.empty_cache()
        parity, kern = _av_parity(torch, card, timer, full)
        emit(phase="audio_vlm_parity", arch=arch, **parity,
             kernels={k: {f: v[f] for f in ("ms", "bound_ms", "library_ms",
                                            "plan")}
                      for k, v in kern.items()})
        torch.cuda.empty_cache()
    saver.shutdown(wait=False)
    emit(phase="serve_audio_vlm_total", seconds=time.monotonic() - t_phase)
    return served, tpav


def _tp_av_rank(rank, world, runs):
    """One rank of ``serve_tp_av`` (a spawned process, gloo on card 0):
    start the group from the ``file://`` store in ``TP_AV_DIR``; per model
    wait for the tree ``serve_audio_vlm`` hands over, load it
    memory-mapped, cut this rank's shard (``export.shard_params``), move
    it to the card and serve the short traffic of its file: whisper
    through ``serve_loop.generate(frames=)`` (``_whisper_short``: the
    prefill's last logits gathered), the VLM through the paged engine,
    phased then mixed (``_tp_av_engine``). The launch counters and the
    collectives are reset just before and read just after each run.
    Pickles what it saw to ``rank<r>.pkl`` in ``TP_AV_DIR``."""
    import pickle
    _die_with_parent()

    import torch
    import torch.distributed as tdist
    from repro_torch.distributed.context import (DistContext,
                                                 init_process_group,
                                                 make_mesh)
    from repro_torch.models import whisper
    from repro_torch.serving import export
    torch.cuda.set_device(0)
    init_process_group(TP_AV_DIR, rank, world, "gloo")
    coll = _count_collectives(tdist)
    out = {"rank": rank, "device": torch.cuda.current_device(), "runs": {}}
    try:
        mesh = make_mesh((1, world), ("data", "model"))
        dist = DistContext(mesh)
        for arch, r in runs.items():
            cfg = r["cfg"]
            deadline = time.monotonic() + TP_TIMEOUT_S
            while not os.path.exists(r["path"]):    # being written
                check(time.monotonic() < deadline,
                      f"serve_tp_av: {r['path']} was never written")
                time.sleep(0.05)
            t0 = time.monotonic()
            saved = torch.load(r["path"], map_location="cpu", mmap=True,
                               weights_only=False)
            local = _tree_to(export.shard_params(cfg, saved["params"], mesh),
                             DEVICE)
            inputs = saved["inputs"]
            del saved
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            a = {"shard_s": time.monotonic() - t0,
                 "weight_bytes": export.memory_report(cfg, local)["bytes"]}
            if cfg.family == "audio":
                cross, seen = whisper.prefill_cross, {}

                def counted(*args, **kw):
                    ck, cv = cross(*args, **kw)
                    seen["cross_cache_bytes"] = 2 * ck.numel() * \
                        ck.element_size()
                    return ck, cv

                whisper.prefill_cross = counted
                _reset_counts()
                coll.clear()
                t0 = time.monotonic()
                try:
                    toks, last, st = _whisper_short(
                        torch, cfg, local, inputs["prompts"],
                        inputs["frames"].to(DEVICE), dist)
                finally:
                    whisper.prefill_cross = cross
                a.update(streams=toks, logits=last[:4].numpy(),
                         wall_s=time.monotonic() - t0,
                         launches=_read_counts(),
                         collectives={k: dict(v) for k, v in coll.items()},
                         tok_per_s=st["tok_per_s"], **seen)
            else:
                coll.clear()
                a["engine"] = _tp_av_engine(torch, cfg, local,
                                            inputs["prompts"], dist)
                a["collectives"] = {k: dict(v) for k, v in coll.items()}
            a["peak_bytes"] = torch.cuda.max_memory_allocated()
            del local
            torch.cuda.empty_cache()
            out["runs"][arch] = a
    finally:
        tdist.destroy_process_group()
    with open(os.path.join(TP_AV_DIR, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _serve_tp_av_start(torch):
    """Spawn ``serve_tp_av``'s ``TP_AV_SIZE`` ranks (``_tp_av_rank``),
    gloo sharing card 0, each pointed at the files ``serve_audio_vlm``
    will write (each rank waits for a file its writer has finished).
    They start before ``serve_ssm`` and serve beside ``serve_audio_vlm``
    and ``serve_ep``'s join."""
    from repro_torch.configs import get_config
    shutil.rmtree(TP_AV_WEIGHTS, ignore_errors=True)
    runs = {a: {"cfg": get_config(a),
                "path": os.path.join(TP_AV_WEIGHTS, f"{a}.pt")}
            for a in AUDIO_VLM_RUNS}
    return _start_ranks(TP_AV_DIR, _tp_av_rank, TP_AV_SIZE,
                        (TP_AV_SIZE, runs))


def _whole_bytes(cfg, packed, mesh):
    """Bytes of the leaves of ``packed`` that a rank of ``mesh`` holds
    whole (``shard_params`` hands them over unsplit)."""
    from repro_torch.serving import export
    local = export.shard_params(cfg, packed, mesh)
    return sum(
        export.memory_report(cfg, {"x": a})["bytes"]
        for a, b in zip(export._leaves(packed), export._leaves(local))
        if (a.blocks is b.blocks if hasattr(a, "blocks") else a is b))


def _tp_av_whisper(torch, card, e, ranks, timer, gen):
    """``serve_tp_av``'s holds on whisper (see ``phase_serve_tp_av``);
    emits its ``tp_kernel`` lines and returns the phase line's fields."""
    from repro_torch.distributed.context import Mesh
    from repro_torch.models import transformer
    from repro_torch.serving import export, serve_loop
    cfg, arch = e["cfg"], e["cfg"].name
    packed = _tree_to(e["host"], DEVICE)
    frames = e["inputs"]["frames"].to(DEVICE)
    prompts = e["inputs"]["prompts"]
    world = len(ranks)
    mesh1 = Mesh(("data", "model"), (1, world), 1)
    full_bytes = export.memory_report(cfg, packed)["bytes"]
    whole = _whole_bytes(cfg, packed, mesh1)
    want_logits = e["logits"].numpy()
    mag = float(np.abs(want_logits).max())
    tol = 2.0 ** -5 * mag
    err = max(float(np.abs(r["runs"][arch]["logits"] - want_logits).max())
              for r in ranks)
    check(err <= tol, f"serve_tp_av {arch}: logits differ by {err} > {tol}")
    near_tie = TP_NEAR_TIE * tol
    r0 = ranks[0]["runs"][arch]
    accepted = []
    for u, w in enumerate(e["streams"]):
        t = _first_divergence(r0["streams"][u], w)
        if t is None:
            continue
        seq = np.concatenate([prompts[u], w[:t]]).astype(np.int32)
        last, _ = serve_loop.prefill_with_decode(
            cfg, packed, seq[None], len(seq), frames=frames[u:u + 1],
            device=DEVICE)
        top2 = torch.topk(last[0].float(), 2).values
        m = float(top2[0] - top2[1])
        check(m < near_tie, f"serve_tp_av {arch}: lane {u} diverged at "
                            f"step {t}, margin {m} >= {near_tie}")
        accepted.append({"lane": u, "step": t, "margin": m})
    steps = TP_AV_PROMPT + TP_AV_TOKENS - 1
    want_bspmm = 2 * (cfg.num_encoder_layers + cfg.num_layers * steps)
    # a decode step: the embedding's all-reduce, then per decoder layer
    # self-attention's, cross-attention's and the MLP's (after its
    # all-gather); the encoder reduce-scatters twice a layer
    want_ar = steps * (1 + 3 * cfg.num_layers)
    want_rs = 2 * cfg.num_encoder_layers
    for r in ranks:
        a = r["runs"][arch]
        check(np.array_equal(a["streams"], r0["streams"]),
              f"serve_tp_av {arch}: rank {r['rank']}'s streams differ from "
              "rank 0's")
        lc = a["launches"]
        check(lc["bspmm"] == want_bspmm,
              f"serve_tp_av {arch}: rank {r['rank']} launched "
              f"{lc['bspmm']} bspmm, {want_bspmm} expected (2 a layer call)")
        for k in ("fused_glu_split", "fused_glu_joint", "paged_flash_decode",
                  "bspmm_t"):
            check(lc[k] == 0, f"serve_tp_av {arch}: {k} launched")
        ar = sum(a["collectives"].get("all_reduce", {}).values())
        rs = sum(a["collectives"].get("reduce_scatter", {}).values())
        check(ar == want_ar and rs == want_rs,
              f"serve_tp_av {arch}: rank {r['rank']} issued {ar} "
              f"all-reduces and {rs} reduce-scatters, {want_ar} and "
              f"{want_rs} expected")
        check(a["weight_bytes"] <= TP_BYTES_FRACTION * full_bytes + whole,
              f"serve_tp_av {arch}: rank {r['rank']} holds "
              f"{a['weight_bytes']} of {full_bytes} bytes")
        check(a["cross_cache_bytes"] * world == e["cross_cache_bytes"],
              f"serve_tp_av {arch}: rank {r['rank']}'s cross K/V "
              f"{a['cross_cache_bytes']} bytes, one device's "
              f"{e['cross_cache_bytes']}")
    local = export.shard_params(cfg, packed, mesh1)
    lines = {}
    for stack, m in (("encoder", ARCH_BATCH * AUDIO_FRAMES),
                     ("decoder", ARCH_M)):
        mlp0 = transformer._layer_view(local[stack], 0)["mlp"]
        for w in ("w_in", "w_out"):
            lines[f"{stack}/{w}"] = _bspmm_line(
                torch, card, timer, gen, "tp_kernel", mlp0[w], m, arch=arch,
                weight=f"{stack}/mlp/{w}", tp=world, rank=1,
                partial=mlp0[w].partial)
    del local, packed
    return dict(
        entry="export.shard_params -> serve_loop.generate(frames=, dist=)",
        encoder_layers=cfg.num_encoder_layers, frames=AUDIO_FRAMES,
        streams_equal_single_device=True, accepted_divergences=accepted,
        near_tie=near_tie, logits_max_abs_err=err, logits_tol=tol,
        logits_err_over_tol=err / tol, bspmm_per_layer_call=2,
        all_reduces=want_ar, reduce_scatters=want_rs,
        all_reduces_per_decode_step=want_ar // steps,
        collectives_per_rank=[r["runs"][arch]["collectives"] for r in ranks],
        weight_bytes_per_rank=[r["runs"][arch]["weight_bytes"]
                               for r in ranks],
        single_device_weight_bytes=full_bytes, whole_leaf_bytes=whole,
        cross_cache_bytes_per_rank=[r["runs"][arch]["cross_cache_bytes"]
                                    for r in ranks],
        single_device_cross_cache_bytes=e["cross_cache_bytes"],
        wall_s=[r["runs"][arch]["wall_s"] for r in ranks],
        tok_per_s=[r["runs"][arch]["tok_per_s"] for r in ranks],
        launches=[r["runs"][arch]["launches"] for r in ranks],
        kernel_lines={k: {f: v[f] for f in ("ms", "bound_ms", "library_ms",
                                            "max_abs_err")}
                      for k, v in lines.items()})


def _tp_av_vlm(torch, e, ranks):
    """``serve_tp_av``'s holds on the VLM (see ``phase_serve_tp_av``);
    returns the phase line's fields."""
    from repro_torch.distributed.context import Mesh
    from repro_torch.serving import export
    cfg, arch = e["cfg"], e["cfg"].name
    packed = _tree_to(e["host"], DEVICE)
    prompts = e["inputs"]["prompts"]
    world = len(ranks)
    full_bytes = export.memory_report(cfg, packed)["bytes"]
    whole = _whole_bytes(cfg, packed, Mesh(("data", "model"), (1, world), 1))
    tol = 2.0 ** -5 * max(float(_last_logits(torch, cfg, packed, p)
                                .abs().max()) for p in prompts[:4])
    near_tie = TP_NEAR_TIE * tol
    single = e["single"]
    accepted = {}
    for name in ("phased", "mixed"):
        r0 = ranks[0]["runs"][arch]["engine"][name]
        accepted[name] = _near_tie_equal(
            torch, cfg, packed, prompts, dict(enumerate(r0["streams"])),
            dict(enumerate(single[name]["streams"])),
            f"serve_tp_av {arch} {name}", tol=near_tie)
        for r in ranks:
            got = r["runs"][arch]["engine"][name]
            for a, b in zip(got["streams"], r0["streams"]):
                check(np.array_equal(a, b), f"serve_tp_av {arch} {name}: "
                      f"rank {r['rank']}'s streams differ from rank 0's")
            check(got["ok"], f"serve_tp_av {arch} {name}: a request failed")
            check(got["digest"] == single[name]["digest"],
                  f"serve_tp_av {arch} {name}: rank {r['rank']}'s block "
                  "tables and page accounting differ from one device's")
            check(got["kv_pool_bytes"] * world
                  == single[name]["kv_pool_bytes"],
                  f"serve_tp_av {arch} {name}: rank {r['rank']}'s KV pool "
                  f"{got['kv_pool_bytes']} bytes")
            for k in PAGED:
                check(got["launches"][k] > 0, f"serve_tp_av {arch} {name}: "
                      f"rank {r['rank']} never launched {k}")
        if name == "mixed":
            check(r0["stalled_decode_steps"] == 0,
                  f"serve_tp_av {arch} mixed: decode stalled")
    for r in ranks:
        check(r["runs"][arch]["weight_bytes"]
              <= TP_BYTES_FRACTION * full_bytes + whole,
              f"serve_tp_av {arch}: rank {r['rank']} holds "
              f"{r['runs'][arch]['weight_bytes']} of {full_bytes} bytes")
    del packed
    return dict(
        entry="export.shard_params -> Engine(dist=) (paged)",
        streams_equal_single_device=True, digests_equal_single_device=True,
        accepted_divergences=accepted, near_tie=near_tie,
        weight_bytes_per_rank=[r["runs"][arch]["weight_bytes"]
                               for r in ranks],
        single_device_weight_bytes=full_bytes, whole_leaf_bytes=whole,
        kv_pool_bytes_per_rank=[r["runs"][arch]["engine"]["phased"][
            "kv_pool_bytes"] for r in ranks],
        single_device_kv_pool_bytes=single["phased"]["kv_pool_bytes"],
        collectives_per_rank=[r["runs"][arch]["collectives"] for r in ranks],
        runs={name: [{k: v for k, v in r["runs"][arch]["engine"][name]
                      .items() if k != "streams"} for r in ranks]
              for name in ("phased", "mixed")},
        single_device={name: {k: v for k, v in single[name].items()
                              if k != "streams"}
                       for name in ("phased", "mixed")})


def phase_serve_tp_av(torch, card, tpav, procs):
    """The two families this slice admits under ``dist=`` beside the
    dense and MoE ones, whole at full width and depth, served at a model
    axis of ``TP_AV_SIZE`` ranks over gloo on one card (which measures no
    tensor-parallel speed and claims none), each rank holding its shard
    of the tree ``serve_audio_vlm`` packed (``export.shard_params``):
    whisper-large-v3 (32 + 32 layers, heads padded 20 -> 32: rank 0's 16
    live, rank 1's 4 live and 12 padded; its two-matrix MLPs split
    ``w_in`` on its block-columns and ``w_out`` on its kept blocks)
    through ``serve_loop.generate(frames=, dist=)``, and internvl2-2b
    (24 layers) through the paged ``Engine``, phased and mixed, on the
    short traffic of ``TP_AV_*``.

    Holds, per rank: the streams equal one device's runs of the same
    traffic in ``serve_audio_vlm`` (a first divergence only where one
    device's top-2 margin is below ``TP_NEAR_TIE`` times the logits
    tolerance, 2**-5 of their magnitude) and equal across ranks;
    whisper's prefill logits of 4 prompts within that tolerance,
    ``bspmm`` launched exactly twice a layer call and no GLU, paged
    decode or ``bspmm_t``, 1 + 3L all-reduces a decode step and two
    reduce-scatters an encoder layer, its cross K/V half of one device's;
    the VLM's block-table digests equal one device's, the split GLU,
    ``bspmm`` and paged decode launched, its KV pool 1/``TP_AV_SIZE`` of
    one device's; each rank's weight bytes at most ``TP_BYTES_FRACTION``
    of one device's plus the leaves every rank holds whole. Then
    whisper's ``bspmm`` at rank 1's shard-local packs of layer 0 at M =
    ARCH_BATCH x AUDIO_FRAMES (the encoder) and ARCH_M (a decode step),
    each held against its plain version (``tp_kernel`` lines). Returns
    the ranks' launch counts."""
    t_phase = time.monotonic()
    ranks = _join_ranks("serve_tp_av", TP_AV_DIR, procs)
    shutil.rmtree(TP_AV_WEIGHTS)
    timer = Timer(torch)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 29)
    counts = []
    for arch, e in tpav.items():
        cfg = e["cfg"]
        if cfg.family == "audio":
            fields = _tp_av_whisper(torch, card, e, ranks, timer, gen)
            counts += fields["launches"]
        else:
            fields = _tp_av_vlm(torch, e, ranks)
            counts += [r["runs"][arch]["engine"][name]["launches"]
                       for r in ranks for name in ("phased", "mixed")]
        emit(phase="serve_tp_av", arch=arch, family=cfg.family,
             layers=cfg.num_layers, reduced=None, tp=len(ranks),
             backend="gloo", devices=[r["device"] for r in ranks],
             lanes=ARCH_BATCH, prompt_len=TP_AV_PROMPT,
             new_tokens=TP_AV_TOKENS, **fields,
             shard_s=[r["runs"][arch]["shard_s"] for r in ranks],
             peak_bytes_per_rank=[r["runs"][arch]["peak_bytes"]
                                  for r in ranks],
             to_host_s=e["to_host_s"], save_s=e["saved"].result(),
             tok_per_s_note="two ranks on one card over gloo: the "
                            "phase's own rate, not a tensor-parallel "
                            "speed")
        gc.collect()
        torch.cuda.empty_cache()
    tpav.clear()
    emit(phase="serve_tp_av_total", seconds=time.monotonic() - t_phase)
    return counts


def _ssm_short(torch, cfg, params, prompts, dist=None):
    """``serve_loop.generate`` of ``TP_AV_TOKENS`` new tokens on
    ``prompts`` (B, TP_AV_PROMPT). Returns (the generated tokens (B,
    TP_AV_TOKENS), the stats)."""
    from repro_torch.serving import serve_loop
    toks, st = serve_loop.generate(cfg, params, prompts,
                                   max_new_tokens=TP_AV_TOKENS,
                                   device=DEVICE, dist=dist)
    return toks[:, prompts.shape[1]:], st


def _bf16_drift(torch, cfg, f32, packed, prompts):
    """How far one device's bf16 activations move the packed model: the
    prompts' last logits through the decode step with ``cfg``'s bf16
    against ``f32``'s f32 activations, as max abs difference and over
    the f32 logits' magnitude."""
    from repro_torch.serving import serve_loop
    lb, _ = serve_loop.prefill_with_decode(cfg, packed, prompts,
                                           prompts.shape[1], device=DEVICE)
    lf, _ = serve_loop.prefill_with_decode(f32, packed, prompts,
                                           prompts.shape[1], device=DEVICE)
    err, mag = float((lb.float() - lf).abs().max()), float(lf.abs().max())
    return {"max_abs": err, "over_magnitude": err / mag, "f32_magnitude": mag}


def _kernel_variant(torch, pack, dtype):
    """The ``bspmm`` kernel and split that ``pack`` takes at ARCH_M rows
    of ``dtype`` activations (``launch_plan``: "fma" or an mma one)."""
    from repro_torch.kernels import bspmm
    x = torch.zeros(ARCH_M, pack.kb * pack.blocks.shape[-2], dtype=dtype,
                    device=pack.blocks.device)
    return bspmm.launch_plan(x, pack).describe()


def _ssm_tp_rank(rank, world, runs):
    """One rank of ``serve_ssm_tp`` (a spawned process, gloo on card 0):
    start the group from the ``file://`` store in ``SSM_TP_DIR``; per
    model wait for the tree ``serve_ssm`` hands over, load it
    memory-mapped, cut this rank's shard (``export.shard_params``: the
    time mix's heads and zamba's Mamba heads, its ``in_proj`` and conv
    cut by meaning, the channel mix and shared MLP packs as mlp2's and the
    GLU's), move it to the card and serve the short traffic through
    ``serve_loop.generate(dist=)`` in each pass of ``SSM_TP_PASSES``.
    The launch counters and the collectives are reset just before and
    read just after each run; after a "logits" pass, the last logits of
    the prompts followed by its own streams (teacher-forced through
    ``prefill_with_decode``, the vocabulary gathered whole). Pickles what
    it saw to ``rank<r>.pkl`` in ``SSM_TP_DIR``."""
    import pickle
    _die_with_parent()

    import torch
    import torch.distributed as tdist
    from repro_torch.distributed.context import (DistContext,
                                                 init_process_group,
                                                 make_mesh)
    from repro_torch.models import transformer
    from repro_torch.serving import export, serve_loop
    torch.cuda.set_device(0)
    init_process_group(SSM_TP_DIR, rank, world, "gloo")
    coll = _count_collectives(tdist)
    out = {"rank": rank, "device": torch.cuda.current_device(), "runs": {}}
    try:
        mesh = make_mesh((1, world), ("data", "model"))
        dist = DistContext(mesh)
        for arch, r in runs.items():
            cfg = r["cfg"]
            deadline = time.monotonic() + TP_TIMEOUT_S
            while not os.path.exists(r["path"]):    # being written
                check(time.monotonic() < deadline,
                      f"serve_ssm_tp: {r['path']} was never written")
                time.sleep(0.05)
            t0 = time.monotonic()
            saved = torch.load(r["path"], map_location="cpu", mmap=True,
                               weights_only=False)
            local = _tree_to(export.shard_params(cfg, saved["params"], mesh),
                             DEVICE)
            prompts = saved["inputs"]["prompts"]
            del saved
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            a = {"shard_s": time.monotonic() - t0,
                 "weight_bytes": export.memory_report(cfg, local)["bytes"]}
            pack = (local["shared"]["mlp"]["w_down"]
                    if cfg.family == "hybrid" else transformer._layer_view(
                        local["layers"], 0)["mlp"]["w_out"])
            for kind, dtype in r["passes"].items():
                pcfg = dataclasses.replace(cfg, compute_dtype=dtype)
                _reset_counts()
                coll.clear()
                t0 = time.monotonic()
                toks, st = _ssm_short(torch, pcfg, local, prompts, dist)
                a[kind] = dict(
                    dtype=dtype, streams=toks, wall_s=time.monotonic() - t0,
                    launches=_read_counts(),
                    collectives={k: dict(v) for k, v in coll.items()},
                    tok_per_s=st["tok_per_s"],
                    variant=_kernel_variant(torch, pack, getattr(torch,
                                                                 dtype)))
                if kind == "logits":
                    seqs = np.concatenate([prompts, toks[:, :-1]], axis=1)
                    last, _ = serve_loop.prefill_with_decode(
                        pcfg, local, seqs, seqs.shape[1], device=DEVICE,
                        dist=dist)
                    if dist.shards(cfg.vocab_size):
                        last = dist.all_gather(last, dim=-1)
                    a[kind]["last"] = last.float().cpu()
            a["peak_bytes"] = torch.cuda.max_memory_allocated()
            del local
            torch.cuda.empty_cache()
            out["runs"][arch] = a
    finally:
        tdist.destroy_process_group()
    with open(os.path.join(SSM_TP_DIR, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _serve_ssm_tp_start(torch):
    """Spawn ``serve_ssm_tp``'s ``SSM_TP_SIZE`` ranks (``_ssm_tp_rank``),
    gloo sharing card 0, each pointed at the files ``serve_ssm`` will
    write. They start before ``serve_ssm`` and serve beside it and the
    phases after it, and are joined after ``serve_tp_av``."""
    from repro_torch.configs import get_config
    shutil.rmtree(SSM_TP_WEIGHTS, ignore_errors=True)
    runs = {a: {"cfg": get_config(a), "passes": SSM_TP_PASSES[a],
                "path": os.path.join(SSM_TP_WEIGHTS, f"{a}.pt")}
            for a in SSM_RUNS}
    return _start_ranks(SSM_TP_DIR, _ssm_tp_rank, SSM_TP_SIZE,
                        (SSM_TP_SIZE, runs))


def _ssm_decode_collectives(cfg) -> dict:
    """The collectives of one ``decode_step`` at a model axis of 2: the
    embedding's all-reduce; rwkv6 a layer: the time mix's ``w_o``
    all-reduce, the channel mix's all-gather of its activation and the
    all-reduce of ``w_out``'s partial sums; zamba a Mamba layer: the
    gated norm's square-sum all-reduce and ``out_proj``'s, and an
    application of the shared block: attention's all-reduce, the GLU's
    all-gather and the down projection's all-reduce."""
    from repro_torch.models import zamba
    if cfg.family == "ssm":
        return {"all_reduce": 1 + 2 * cfg.num_layers,
                "all_gather": cfg.num_layers}
    napp = zamba.n_shared_applications(cfg)
    return {"all_reduce": 1 + 2 * napp + 2 * cfg.num_layers,
            "all_gather": napp}


def phase_serve_ssm_tp(torch, card, ssmtp, procs):
    """The recurrent families under ``dist=``, whole at full width and
    depth, served at a model axis of ``SSM_TP_SIZE`` ranks over gloo on
    one card (which measures no tensor-parallel speed and claims none),
    each rank holding its shard of the tree ``serve_ssm`` packed:
    rwkv6-3b (32 layers, 48 heads: 24 a rank, rank 1's 16 live and 8
    padded; its channel mix splits ``w_in`` on its block-columns and
    ``w_out`` on its kept blocks) and zamba2-1.2b (38 Mamba2 layers of 64
    heads, 32 a rank, ``in_proj`` and the conv cut by meaning; the shared
    block's heads and GLU split), through ``serve_loop.generate(dist=)``
    on the short traffic of ``TP_AV_*``, in the passes of
    ``SSM_TP_PASSES``. The served pass takes f32 activations on the
    packed bf16 weights, here and in the one-device oracle, since the
    random models at full depth are chaotic under bf16 activations (one
    device's bf16 and f32 runs of the same weights differ by
    ``bf16_drift``, printed), so a bf16 sum taken in another order, as
    the model axis takes it, flips tokens no near-tie bound can tell from
    a fault; the bf16 pass runs the mma kernels under ``dist=`` too.

    Holds, per rank and pass: ``bspmm`` launched exactly twice a layer
    call for rwkv6, and the split GLU and ``bspmm`` once an application
    of the shared block for zamba; the all-reduces exactly those of
    ``_ssm_decode_collectives`` for every decode step (the all-gathers
    printed: those plus one for each greedy token); the streams equal
    across ranks. The served pass's streams equal one device's run of the
    same traffic in its dtype in ``serve_ssm`` (a first divergence only
    where one device's top-2 margin is below ``TP_NEAR_TIE`` times the
    logits tolerance, 2**-5 of their magnitude). A "logits" pass's
    teacher-forced last logits are equal on every rank and within
    ``TP_NEAR_TIE`` times one device's bf16 drift on the same prefixes
    (the largest |bf16 - f32| of its last logits) of one device's bf16.
    Each rank's weight bytes at most ``TP_BYTES_FRACTION`` of one
    device's plus the leaves every rank holds whole. Then rwkv6's
    ``bspmm`` at rank 1's shard-local packs of layer 0 at M = ARCH_M
    (``tp_kernel`` lines). Returns the ranks' launch counts."""
    from repro_torch.distributed.context import Mesh
    from repro_torch.models import transformer, zamba
    from repro_torch.serving import export, serve_loop
    t_phase = time.monotonic()
    ranks = _join_ranks("serve_ssm_tp", SSM_TP_DIR, procs)
    shutil.rmtree(SSM_TP_WEIGHTS)
    timer = Timer(torch)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 30)
    counts = []
    world = len(ranks)
    steps = TP_AV_PROMPT + TP_AV_TOKENS - 1
    for arch, e in ssmtp.items():
        cfg, host = e["cfg"], e["host"]
        prompts = e["inputs"]["prompts"]
        mesh1 = Mesh(("data", "model"), (1, world), 1)
        full_bytes = export.memory_report(cfg, host)["bytes"]
        whole = _whole_bytes(cfg, host, mesh1)
        r0 = ranks[0]["runs"][arch]
        accepted, on_card = [], {}

        def card_tree():
            # one device's tree, moved to the card only where needed
            if not on_card:
                on_card["p"] = _tree_to(host, DEVICE)
            return on_card["p"]

        def last_of(u, t):
            seq = np.concatenate([prompts[u], e["streams"][u][:t]]).astype(
                np.int32)
            last, _ = serve_loop.prefill_with_decode(
                cfg, card_tree(), seq[None], len(seq), device=DEVICE)
            return last[0].float()
        # the magnitude of one device's f32 last logits of the prompts
        tol = 2.0 ** -5 * e["bf16_drift"]["f32_magnitude"]
        near_tie = TP_NEAR_TIE * tol
        for u, w in enumerate(e["streams"]):
            t = _first_divergence(r0["served"]["streams"][u], w)
            if t is None:
                continue
            top2 = torch.topk(last_of(u, t), 2).values
            m = float(top2[0] - top2[1])
            check(m < near_tie, f"serve_ssm_tp {arch}: lane {u} diverged "
                                f"at step {t}, margin {m} >= {near_tie}")
            accepted.append({"lane": u, "step": t, "margin": m})
        per_step = _ssm_decode_collectives(cfg)
        want_ar = steps * per_step["all_reduce"]
        if cfg.family == "ssm":
            want = {"bspmm": 2 * cfg.num_layers * steps}
        else:
            napp = zamba.n_shared_applications(cfg)
            want = {"bspmm": napp * steps, "fused_glu_split": napp * steps}
        passes = SSM_TP_PASSES[arch]
        for r in ranks:
            a = r["runs"][arch]
            for kind in passes:
                check(np.array_equal(a[kind]["streams"], r0[kind]["streams"]),
                      f"serve_ssm_tp {arch} {kind}: rank {r['rank']}'s "
                      "streams differ from rank 0's")
                lc = a[kind]["launches"]
                for k, n in want.items():
                    check(lc[k] == n, f"serve_ssm_tp {arch} {kind}: rank "
                                      f"{r['rank']} launched {lc[k]} {k}, "
                                      f"{n} expected")
                ar = sum(a[kind]["collectives"].get("all_reduce",
                                                    {}).values())
                check(ar == want_ar, f"serve_ssm_tp {arch} {kind}: rank "
                                     f"{r['rank']} issued {ar} all-reduces, "
                                     f"{want_ar} expected")
                counts.append(lc)
            check(a["weight_bytes"] <= TP_BYTES_FRACTION * full_bytes + whole,
                  f"serve_ssm_tp {arch}: rank {r['rank']} holds "
                  f"{a['weight_bytes']} of {full_bytes} bytes")
        teacher = None
        if "logits" in passes:
            # the logits pass: the ranks' teacher-forced last logits
            # against one device's in bf16 on the same prefixes, within
            # TP_NEAR_TIE times one device's bf16 drift there
            got = r0["logits"]["last"]
            for r in ranks:
                check(torch.equal(r["runs"][arch]["logits"]["last"], got),
                      f"serve_ssm_tp {arch}: rank {r['rank']}'s teacher-"
                      "forced logits differ from rank 0's")
            seqs = np.concatenate([prompts, r0["logits"]["streams"][:, :-1]],
                                  axis=1)
            one = {}
            for dtype in ("bfloat16", "float32"):
                last, _ = serve_loop.prefill_with_decode(
                    dataclasses.replace(cfg, compute_dtype=dtype),
                    card_tree(), seqs, seqs.shape[1], device=DEVICE)
                one[dtype] = last.float().cpu()
            drift = float((one["bfloat16"] - one["float32"]).abs().max())
            err = float((got - one["bfloat16"]).abs().max())
            check(bool(torch.isfinite(got).all()),
                  f"serve_ssm_tp {arch}: non-finite teacher-forced logits")
            check(err <= TP_NEAR_TIE * drift,
                  f"serve_ssm_tp {arch}: teacher-forced bf16 logits off one "
                  f"device's by {err} > {TP_NEAR_TIE} x drift {drift}")
            single_streams = _ssm_short(
                torch, dataclasses.replace(cfg, compute_dtype="bfloat16"),
                card_tree(), prompts)[0]
            teacher = dict(
                prefix_len=int(seqs.shape[1]), max_abs_err=err,
                one_device_bf16_drift=drift, bound=TP_NEAR_TIE * drift,
                magnitude=float(one["float32"].abs().max()),
                bf16_streams_first_divergence=[
                    _first_divergence(g, w) for g, w in zip(
                        r0["logits"]["streams"], single_streams)])
        lines = {}
        if cfg.family == "ssm":
            local = export.shard_params(
                cfg, _tree_to(_first_layers(host, 1), DEVICE), mesh1)
            mlp0 = transformer._layer_view(local["layers"], 0)["mlp"]
            for w in ("w_in", "w_out"):
                lines[w] = _bspmm_line(
                    torch, card, timer, gen, "tp_kernel", mlp0[w], ARCH_M,
                    arch=arch, weight=f"layers/mlp/{w}", tp=world, rank=1,
                    partial=mlp0[w].partial)
            del local

        def per_rank(kind, key):
            return [r["runs"][arch][kind][key] for r in ranks]
        emit(phase="serve_ssm_tp", arch=arch, family=cfg.family,
             layers=cfg.num_layers, reduced=None, tp=world, backend="gloo",
             devices=[r["device"] for r in ranks],
             entry="export.shard_params -> serve_loop.generate(dist=)",
             lanes=ARCH_BATCH, prompt_len=TP_AV_PROMPT,
             new_tokens=TP_AV_TOKENS, streams_equal_single_device=True,
             accepted_divergences=accepted, near_tie=near_tie,
             decode_steps=steps, collectives_per_decode_step=per_step,
             all_reduces=want_ar,
             weight_bytes_per_rank=[r["runs"][arch]["weight_bytes"]
                                    for r in ranks],
             single_device_weight_bytes=full_bytes, whole_leaf_bytes=whole,
             passes={kind: dict(
                 activations=dtype,
                 kernel_variant=per_rank(kind, "variant"),
                 collectives_per_rank=per_rank(kind, "collectives"),
                 launches=per_rank(kind, "launches"),
                 wall_s=per_rank(kind, "wall_s"),
                 tok_per_s=per_rank(kind, "tok_per_s"))
                 for kind, dtype in passes.items()},
             teacher_forced=teacher,
             single_device_tok_per_s=e["single_tok_per_s"],
             bf16_drift=e["bf16_drift"],
             shard_s=[r["runs"][arch]["shard_s"] for r in ranks],
             peak_bytes_per_rank=[r["runs"][arch]["peak_bytes"]
                                  for r in ranks],
             to_host_s=e["to_host_s"], save_s=e["saved"].result(),
             kernel_lines={k: {f: v[f] for f in ("ms", "bound_ms",
                                                 "library_ms",
                                                 "max_abs_err")}
                           for k, v in lines.items()},
             tok_per_s_note="two ranks on one card over gloo: the phase's "
                            "own rate, not a tensor-parallel speed")
        del on_card
        gc.collect()
        torch.cuda.empty_cache()
    ssmtp.clear()
    emit(phase="serve_ssm_tp_total", seconds=time.monotonic() - t_phase)
    return counts


def _dp_rank(rank, world, cfg, dirs, prompts, loop_prompts, cut):
    """One rank of ``serve_dp`` (a spawned process, gloo on card 0): start
    the group from the ``file://`` store in ``DP_DIR`` on a (data, model)
    = ``DP_SHAPE`` mesh, load the sealed split artifact and keep this
    rank's shard (the model axis splits it; the data axis does not), then
    serve the 12 requests through the engine, phased and mixed (one
    replica a data group, request i to group i mod 2; ``run`` returns
    every request on every rank), and the cut oracle prompts through
    ``serve_loop.generate`` (each group its rows). Launch counts and
    collectives reset before and read after each run. Pickles what it
    saw to ``rank<r>.pkl`` in ``DP_DIR``. ``cut``: the parent's
    (``DP_TOKENS``, ``DP_LOOP_LEN``, ``DP_LOOP_TOKENS``)."""
    import pickle
    _die_with_parent()
    new, loop_len, loop_new = cut

    import torch
    import torch.distributed as tdist
    from repro_torch.distributed.context import (DistContext,
                                                 init_process_group,
                                                 make_mesh)
    from repro_torch.serving import artifact, export, serve_loop
    from repro_torch.serving.engine import Engine
    torch.cuda.set_device(0)
    init_process_group(DP_DIR, rank, world, "gloo")
    coll = _count_collectives(tdist)
    try:
        mesh = make_mesh(DP_SHAPE, ("data", "model"))
        dist = DistContext(mesh)
        out = {"rank": rank, "device": torch.cuda.current_device(),
               "data_rank": dist.data_rank, "model_rank": dist.model_rank}
        t0 = time.monotonic()
        full, _ = artifact.load(dirs["split"], cfg, device=DEVICE)
        params = export.shard_params(cfg, full, mesh)
        del full
        torch.cuda.empty_cache()
        out["shard_s"] = time.monotonic() - t0
        out["weight_bytes"] = export.memory_report(cfg, params)["bytes"]
        runs = {}
        for name, mode in (("phased", {}), ("mixed", {"mixed": True})):
            _reset_counts()
            coll.clear()
            eng = Engine(cfg, params, device=DEVICE, dist=dist, **ENGINE,
                         **mode)
            uids = [eng.submit(p, new) for p in prompts]
            t0 = time.monotonic()
            res = eng.run()
            runs[name] = dict(
                uids=uids, streams=[res[u].generated for u in uids],
                ok=all(res[u].ok for u in uids),
                wall_s=time.monotonic() - t0, lanes=eng.max_batch,
                digest=eng.lockstep_digest,
                group_digests=eng.data_group_digests,
                launches=_read_counts(),
                collectives={k: dict(v) for k, v in coll.items()},
                **{k: eng.stats[k] for k in (
                    "tok_per_s", "stalled_decode_steps", "mixed_steps",
                    "decode_slabs", "prefill_chunks")})
            del eng
        _reset_counts()
        t0 = time.monotonic()
        toks, st = serve_loop.generate(
            cfg, params, np.stack([p[:loop_len] for p in loop_prompts]),
            max_new_tokens=loop_new, device=DEVICE, dist=dist)
        runs["serve_loop"] = dict(streams=toks[:, loop_len:],
                                  wall_s=time.monotonic() - t0,
                                  launches=_read_counts(),
                                  tok_per_s=st["tok_per_s"])
        out["runs"] = runs
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    finally:
        tdist.destroy_process_group()
    with open(os.path.join(DP_DIR, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _serve_dp_start(torch, cfg, dirs, prompts, loop_prompts):
    """Spawn ``serve_dp``'s ranks (``_dp_rank``), gloo sharing card 0;
    they load the sealed artifact and serve beside ``serve_swap`` and
    ``serve_tp``'s ranks, and are joined after ``serve_tp``."""
    world = math.prod(DP_SHAPE)
    torch.cuda.synchronize()
    return _start_ranks(DP_DIR, _dp_rank, world,
                        (world, cfg, dirs, prompts, loop_prompts,
                         (DP_TOKENS, DP_LOOP_LEN, DP_LOOP_TOKENS)))


def _dp_group_oracle(torch, cfg, packed, prompts, dp):
    """One device's ``Engine(max_batch=ENGINE's / dp)`` on each data
    group's requests (request i to group i mod dp), phased and mixed.
    -> {mode: [per group: (streams, lockstep digest, launches)]}."""
    from repro_torch.serving.engine import Engine
    out = {}
    for name, mode in (("phased", {}), ("mixed", {"mixed": True})):
        out[name] = []
        for g in range(dp):
            _reset_counts()
            eng = Engine(cfg, packed, device=DEVICE,
                         **dict(ENGINE, max_batch=ENGINE["max_batch"] // dp),
                         **mode)
            uids = [eng.submit(p, DP_TOKENS) for p in prompts[g::dp]]
            res = eng.run()
            out[name].append(([res[u].generated for u in uids],
                              eng.lockstep_digest, _read_counts()))
            del eng
    return out


def phase_serve_dp(torch, cfg, packed, prompts, loop_prompts, procs):
    """Llama-3.2-1B served at full width and depth over a serving data
    axis: (data, model) = ``DP_SHAPE``, four spawned ranks sharing card 0
    over gloo (so this measures no data- or tensor-parallel speed and
    claims none), each holding its model-axis shard of the sealed split
    artifact. The engine runs one replica a data group (4 lanes each of
    the mesh's 8), request i on group i mod 2, phased and mixed; the
    oracle prompts run through ``serve_loop.generate`` with each group's
    rows. The traffic is cut as ``DP_*`` says (printed).

    Holds, per rank: every request's result comes back on every rank (the
    gather over the data axis) and all are ok; the streams equal one
    device's (a first divergence only where one device's margin is below
    ``TP_NEAR_TIE`` logits tolerances) and equal across the 4 ranks; a
    rank's own digest equals its model partner's and the digest of one
    device's ``Engine(max_batch=4)`` on its group's requests
    (``_dp_group_oracle``), and both groups' digests are reported on
    every rank; the split GLU, ``bspmm`` and paged decode launch on every
    rank; ``serve_loop`` streams equal one device's on the same cut
    prompts. Returns the ranks' and the oracles' launch counts."""
    from repro_torch.serving import serve_loop
    t_phase = time.monotonic()
    ranks = _join_ranks("serve_dp", DP_DIR, procs)
    t_oracle = time.monotonic()
    dp = DP_SHAPE[0]
    single = _dp_group_oracle(torch, cfg, packed, prompts, dp)
    counts = [c for runs in single.values() for _, _, c in runs]
    lp = np.stack([p[:DP_LOOP_LEN] for p in loop_prompts])
    loop1, _ = serve_loop.generate(cfg, packed, lp,
                                   max_new_tokens=DP_LOOP_TOKENS,
                                   device=DEVICE)
    single_logits = [_last_logits(torch, cfg, packed, p) for p in prompts[:4]]
    oracle_s = time.monotonic() - t_oracle
    tol = 2.0 ** -5 * max(float(x.abs().max()) for x in single_logits)
    near_tie = TP_NEAR_TIE * tol
    accepted = {}
    r0 = ranks[0]["runs"]
    for name in ("phased", "mixed"):
        want = {u: single[name][u % dp][0][u // dp]
                for u in range(len(prompts))}
        accepted[name] = _near_tie_equal(
            torch, cfg, packed, prompts, dict(enumerate(r0[name]["streams"])),
            want, f"serve_dp {name}", tol=near_tie)
        digests = [d for _, d, _ in single[name]]
        for r in ranks:
            got = r["runs"][name]
            check(got["ok"] and len(got["streams"]) == len(prompts),
                  f"serve_dp {name}: rank {r['rank']} lacks results")
            check(got["lanes"] == ENGINE["max_batch"] // dp,
                  f"serve_dp {name}: {got['lanes']} lanes a group")
            for a, b in zip(got["streams"], r0[name]["streams"]):
                check(np.array_equal(a, b), f"serve_dp {name}: rank "
                      f"{r['rank']}'s streams differ from rank 0's")
            check(got["digest"] == digests[r["data_rank"]],
                  f"serve_dp {name}: rank {r['rank']}'s block tables and "
                  "page accounting differ from one device's replica of "
                  "its group")
            check(got["group_digests"] == digests,
                  f"serve_dp {name}: rank {r['rank']} reports digests "
                  f"{got['group_digests']}, one device's {digests}")
            for k in PAGED:
                check(got["launches"][k] > 0, f"serve_dp {name}: rank "
                      f"{r['rank']} never launched {k}")
            counts.append(got["launches"])
        if name == "mixed":
            check(all(r["runs"][name]["stalled_decode_steps"] == 0
                      for r in ranks), "serve_dp mixed: decode stalled")
    accepted["serve_loop"] = _near_tie_equal(
        torch, cfg, packed, lp,
        dict(enumerate(r0["serve_loop"]["streams"])),
        dict(enumerate(loop1[:, DP_LOOP_LEN:])), "serve_dp serve_loop",
        tol=near_tie)
    for r in ranks:
        lr = r["runs"]["serve_loop"]
        check(np.array_equal(lr["streams"], r0["serve_loop"]["streams"]),
              f"serve_dp serve_loop: rank {r['rank']}'s streams differ")
        check(lr["launches"]["bspmm"] > 0
              and lr["launches"]["fused_glu_split"] > 0,
              "serve_dp serve_loop launched no BSpMM kernel")
        counts.append(lr["launches"])
    emit(phase="serve_dp", model=cfg.name, depth=cfg.num_layers,
         mesh={"data": DP_SHAPE[0], "model": DP_SHAPE[1]}, backend="gloo",
         devices=[r["device"] for r in ranks],
         coords=[[r["data_rank"], r["model_rank"]] for r in ranks],
         requests=len(prompts), new_tokens=DP_TOKENS,
         loop=[len(loop_prompts), DP_LOOP_LEN, DP_LOOP_TOKENS],
         cut={"new_tokens": [NEW_TOKENS, DP_TOKENS],
              "loop_prompt_len": [LOOP_LEN, DP_LOOP_LEN],
              "loop_tokens": [LOOP_TOKENS, DP_LOOP_TOKENS],
              "why": "the time budget: the ranks alone take 102.9 s "
                     "uncut against ~100 s beside serve_swap, the "
                     "oracle 31.8 s"},
         lanes_per_group=ENGINE["max_batch"] // dp,
         streams_equal_single_device=True, accepted_divergences=accepted,
         near_tie=near_tie,
         group_digests={n: [d for _, d, _ in single[n]] for n in single},
         weight_bytes_per_rank=[r["weight_bytes"] for r in ranks],
         peak_bytes_per_rank=[r["peak_bytes"] for r in ranks],
         shard_s=[r["shard_s"] for r in ranks],
         runs={name: [{k: v for k, v in r["runs"][name].items()
                       if k not in ("streams", "uids")} for r in ranks]
               for name in ("phased", "mixed", "serve_loop")},
         tok_per_s_note="four ranks on one card over gloo: the phase's "
                        "own rate, not a data- or tensor-parallel speed",
         join_s=t_oracle - t_phase, oracle_s=oracle_s,
         seconds=time.monotonic() - t_phase)
    return counts


def phase_training(torch, cfg):
    """The training phases, in order: ``train``, the packed fine-tuning
    gradients, the train profile, the unlogged ``obs_train`` run, then
    ``train_ckpt`` beside the chaos children (before them where the card
    lacks ``CKPT_BESIDE_FREE``), ``train_tp``'s ranks warming up beside
    them, and ``train_tp``. Returns the fine-tuning phase's launch
    counts."""
    tcfg, opt, src, state, train_ref = phase_train(torch, cfg)
    ft = phase_finetune_packed(torch, tcfg, state, src.batch(TRAIN_STEPS))
    phase_train_profile(torch, tcfg, opt, src, state)
    phase_obs_train_unlogged(torch, tcfg, opt, src, state)
    # train_tp's ranks start and warm up beside the chaos children (a few
    # GB of the card), then train once those are done; the full-depth
    # checkpoint runs beside the chaos chain's first children where the
    # card has room, with only the state left of the training phases'
    # memory (their cached blocks beside the chain's child ran the card
    # out of memory)
    gc.collect()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    layout = {"card_free_bytes": free,
              "held_bytes": torch.cuda.memory_allocated()}
    layout["beside_chaos"] = free - layout["held_bytes"] >= CKPT_BESIDE_FREE
    held = [state]
    del state

    def ckpt():
        phase_train_ckpt(torch, tcfg, held.pop(), layout)
        gc.collect()
        torch.cuda.empty_cache()
    if not layout["beside_chaos"]:
        ckpt()
    tp = _train_tp_start(torch, tcfg, opt, src)
    with _killed_on_failure(tp[0]):
        phase_train_chaos(torch, cfg,
                          beside=ckpt if layout["beside_chaos"] else None)
    phase_train_tp(torch, tcfg, opt, src, train_ref, tp)
    return ft


def _on_term(signum, frame):
    """SIGTERM: kill the spawned ranks and leave at once (the chaos
    children and the ranks also die with the script: ``_die_with_parent``
    and ``training/faults.py``'s child set the parent-death signal)."""
    import multiprocessing
    for p in multiprocessing.active_children():
        p.kill()
    os._exit(128 + signum)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    signal.signal(signal.SIGTERM, _on_term)
    from repro_torch.configs.paper_models import LLAMA32_1B

    groups = {}

    def mark(name):
        """The seconds since the script started at the end of a phase
        group (the ``timing`` line)."""
        groups[name] = time.monotonic() - T0

    card = phase_env(torch)
    phase_build()
    mark("env_and_build")
    cfg = LLAMA32_1B
    packed, joint, dense = phase_model(torch, cfg)
    summary = phase_kernels(torch, card, packed, joint)
    mark("model_and_kernels")

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(n),))
               .astype(np.int32) for n in rng.integers(32, 129,
                                                       size=N_REQUESTS)]
    warm, prefix_reqs = _prefix_prompts(cfg, rng)
    loop_prompts = [rng.integers(0, cfg.vocab_size, size=LOOP_LEN)
                    .astype(np.int32) for _ in range(LOOP_PROMPTS)]
    phased, counts, st = phase_serve(
        torch, cfg, "packed_split", packed, prompts, NEW_TOKENS,
        must_launch=PAGED, must_not=("fused_glu_joint",))
    served = [counts]
    counts, mixed = phase_serve_modes(torch, cfg, packed, prompts, _brief(st))
    served += counts
    served += phase_obs_serve(torch, cfg, packed, prompts)
    served += phase_serve_prefix(torch, cfg, packed, warm, prefix_reqs)
    counts, loop_gen = phase_serve_loop(torch, cfg, packed, loop_prompts)
    served += counts
    single = {"phased": (phased, st), "mixed": mixed, "serve_loop": loop_gen}
    jres, jcounts, jst = phase_serve(
        torch, cfg, "packed_joint", joint, prompts[:4], 16,
        must_launch=("bspmm", "fused_glu_joint", "paged_flash_decode"),
        must_not=("fused_glu_split",))
    served.append(jcounts)
    single["joint"] = (jres, jst)
    phase_e2e(torch, cfg, packed, dense, prompts)
    served += phase_parity(
        torch, cfg, packed,
        [prefix_reqs[0]] + prompts + loop_prompts + prefix_reqs[1:4])
    mark("llama_serving_through_parity")
    served += phase_serve_frontdoor(torch, cfg, packed, rng)
    served += phase_serve_chaos(torch, cfg, packed, prompts)
    mark("frontdoor_and_chaos")
    dirs, counts = phase_artifact(torch, cfg, packed, joint)
    served += counts
    mark("artifacts")
    # serve_tp's ranks serve beside the swap (a few GB of the card; their
    # streams are compared with the single-device runs once joined)
    tp = _serve_tp_start(torch, cfg, dirs, prompts, loop_prompts)
    # serve_dp's four ranks (data 2, model 2) load the split artifact and
    # serve beside the swap too, joined after serve_tp
    dp_procs = _serve_dp_start(torch, cfg, dirs, prompts, loop_prompts)
    with _killed_on_failure(tp[0] + dp_procs):
        served += phase_serve_swap(torch, cfg, dirs, prompts, rng)
    with _killed_on_failure(dp_procs):
        served += phase_serve_tp(torch, card, cfg, packed, joint, prompts,
                                 loop_prompts, single, tp)
    served += phase_serve_dp(torch, cfg, packed, prompts, loop_prompts,
                             dp_procs)
    shutil.rmtree(ART_DIR)
    mark("serve_swap_and_serve_tp")
    phase_profile(torch, cfg, packed, prompts)
    summary["bspmm_t"] = phase_kernels_t(torch, card, packed)
    del packed, joint, dense
    torch.cuda.empty_cache()
    mark("profile_and_bspmm_t")
    served += phase_serve_arch(torch, card)
    mark("serve_arch")
    moe_counts, ep = phase_serve_moe(torch, card)
    served += moe_counts
    mark("serve_moe")
    # serve_ep's ranks serve serve_moe's models beside the recurrent and
    # audio/VLM phases (a few GB of the card), joined after them
    procs = _serve_ep_start(torch, ep)
    # serve_tp_av's ranks wait for the trees serve_audio_vlm hands them,
    # serve beside it and serve_ep's join, and are joined after that
    av_procs = _serve_tp_av_start(torch)
    # serve_ssm_tp's ranks wait for the trees serve_ssm hands them and
    # serve beside the phases after it; joined after serve_tp_av
    ssm_procs = _serve_ssm_tp_start(torch)
    with _killed_on_failure(procs + av_procs + ssm_procs):
        counts, ssmtp = phase_serve_ssm(torch, card)
        served += counts
        counts, tpav = phase_serve_audio_vlm(torch, card)
        served += counts
    mark("serve_ssm_and_audio_vlm")
    with _killed_on_failure(av_procs + ssm_procs):
        served += phase_serve_ep(torch, card, ep, procs)
    mark("serve_ep_join")
    with _killed_on_failure(ssm_procs):
        served += phase_serve_tp_av(torch, card, tpav, av_procs)
    mark("serve_tp_av_join")
    served += phase_serve_ssm_tp(torch, card, ssmtp, ssm_procs)
    mark("serve_ssm_tp_join")
    ft = phase_training(torch, cfg)
    mark("training")

    kernels = []
    for name, (src, repl) in REPLACES.items():
        s = summary[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=repl,
            launches=sum(c[name] for c in (*served, *ft.values())),
            max_abs_err=s["max_abs_err"], ms=s["ms"],
            plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by=s["bound_by"], library_ms=s["library_ms"],
            matched=True, timed_shape=s["shape"], dtype=s["dtype"],
            **{k: s[k] for k in ("plan", "splits", "profiler_ms")
               if k in s}))
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel never launched on a main path: {kernels}")
    emit(phase="timing", groups=groups,
         group_s={k: v - p for (k, v), p in zip(
             groups.items(), [0.0] + list(groups.values())[:-1])},
         total_s=time.monotonic() - T0)
    emit(kernels=kernels)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
