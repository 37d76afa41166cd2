#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout: ``python3 chip_smoke.py`` (no arguments;
one card).  It imports ``repro_torch`` from ``src/`` and nothing of JAX.
Phases, each printed with its numbers and wall time:

1. build every CUDA kernel of the paths (the backward flash kernel among
   them) from ``src/repro_torch/kernels/csrc``, and the earlier ``runqlat_hist`` and
   ``wkv`` kernels kept in ``tools/earlier/`` to be timed beside their
   replacements (one ``nvcc`` per source, all at once), print the
   registers, shared memory and spills of ``runqlat_hist``,
   ``rollout_tick``, ``ssd_sm90``, ``ssd_bwd_sm90``, ``wkv`` and
   ``wkv_bwd``, and of each head width of
   ``flash_attention_sm90`` and ``flash_attention_f32_sm90`` (8, 16, 64,
   80, 128, 256; a missing one is a failure), the ``HGMMA`` instructions
   in ``flash_attention_sm90``'s SASS and the ``HMMA`` ones in
   ``flash_attention_f32_sm90``'s and ``ssd_sm90``'s (none is a failure);
2. hold ``runqlat_hist`` against its plain version on the card: a tick's
   two sets through the one-launch entry with broadcast masks exactly,
   float weights at n 16 exactly against the CPU's sequential plain
   version, a ragged long shape with float weights to tolerance; then its
   device time from CUDA graphs beside the earlier kernel's two launches,
   the plain version's and ``scatter_add_``'s, and the wrapper call's time
   by CUDA events;
3. run ten ticks at 1,000 nodes on the card and on the CPU with one noise
   bundle: the same state, floats allclose, histogram totals equal;
4. the ICO path at full width: train the Random Forest on the card;
   profile 100 ticks and 20 admissions on the 1,000-node cluster of phase
   3 (host ms and ``runqlat_hist`` launches per tick, which must be one,
   the device's busy share, its top kernels); then ICO ``run_experiment``
   on a 1,000-node fleet with a 300-pod trace, recording its plan, with
   ``runqlat_hist``'s launch count set to 0 before and read after the run
   (one launch a tick);
5. ``schedulers`` (through ``benchmarks/bench_torch_schedulers.py``):
   Figs. 13-15, ``compare_schedulers`` at 12 nodes and 40 pods with phase
   4's forest, one ``runqlat_hist`` launch a tick; then the bench's
   batched axis, each scheduler's headline plan replayed under 20 seeds
   with the fused tick (p99 and avg mean +/- std, wins against HUP), one
   ``rollout_tick`` launch per batched tick, each seed-7 entry held to its
   headline run;
6. one 12-node ICO run on the card and on the CPU with one noise stream:
   the same placements, response times allclose; its plan is recorded;
7. engine parity on that 12-node plan, 3 seeds: the batched engine with
   the fused tick against the default tick on the same draws, and on the
   card against the CPU;
8. the replay path at full width: ``replay_plan_batched`` of the
   1,000-node ICO plan under 20 seeds with the fused tick (batched ticks
   of 20,000 node rows, the plan's real span first and then bucket
   padding), both kernels' counts set to 0 before and read after; rates
   are printed over all ticks and over the real ones;
9. ``rollout_tick`` (``fused_tick_unpacked``, the entry the replay calls,
   reading the tick's tensors where they lie) against its plain version on
   the inputs of the replay's 5,000th batched tick (R = 20,000), kept with
   their strides by an untimed rerun of the replay's first windows, and on
   a ragged R = 37; its times beside the plain version's and beside the
   packing it needed before (``pack`` then the packed entry); then the
   replay's checks: one launch per batched tick, no ``runqlat_hist``
   launch, and the seed-7 entry reproducing phase 4's run;
10. a profile of the batched tick at 20 x 1,000 rows, fused and default;
11. ``paper_models`` (through ``benchmarks/bench_torch_paper.py``): the
    resource model's per-type lines (Figs. 6-7, float64) on the card
    against the CPU; Table II at the bench's default size (250
    placements, the SVR and the MLP trained 1,500 steps; ``--full`` takes
    700), the five regressors fitted and timed on the card (fit s,
    predict µs, MAE / MSE / MAPE / R²), the linear model and the two
    forests against their CPU fits to rtol 1e-4;
12. ``motivation`` (through ``bench_torch_paper``): Table I on the card,
    2,400 single-node ticks, one ``runqlat_hist`` launch each;
13. ``control_12`` (through ``benchmarks/bench_torch_control.py``): the
    profile grid at (trace seed, sim seed) (0, 7) (12 nodes,
    ``bursty_trace(num_online=14)``), each scheduler without and
    with its ``scheduler_loop_config`` loop, p99 off and on, actions, ms
    per control step, one ``runqlat_hist`` launch a tick; the controlled
    ICO run on the card against the CPU with one noise stream (same
    actions, RT to rtol 1e-4); then ICO's plans without and
    with control replayed under 20 seeds with the fused tick (p99 per
    seed, wins, ``rollout_tick`` launches equal to the batched ticks), the
    entry at the run's own sim seed held to its run at 1e-3;
14. ``proactive_12`` (through ``bench_torch_control``): ICO off / reactive
    / proactive and the unified stack (ICO-F and the proactive loop
    sharing one ``ForecastService``) on ``PROACTIVE_TRACE`` cut from 3
    days to ``PROACTIVE_DAYS`` at trace seed 0, sim seed 11, one
    ``runqlat_hist`` launch a tick; the
    unified run traced to a temporary file (every action's chain resolved,
    at least one ``TrustGateTransition``); the unified stack with the
    leverage gate widened on a one-day trace on the card against the CPU on
    one noise stream (counts exact, RT to rtol 1e-4);
15. ``schedulers_forecast`` (through ``bench_torch_schedulers``): the
    forecast axis at its first seed (0, 11) on ``FORECAST_TRACE`` cut to
    ``PROACTIVE_DAYS``: ICO-F with a fresh ``ForecastService`` against
    ICO (phase 14's ``off`` run, checked to be the same run), ``win``
    printed, not asserted; the exact-fallback bar (ICO-F without a
    service equals ICO, p99 and placed bit for bit) on half a day of the
    same trace;
16. ``control_1000``: phase 4's 1,000-node ICO run with the ICO control
    loop stepped every 40 ticks: ticks/s beside phase 4's, ms per control
    step by phase, actions, peak memory, one ``runqlat_hist`` launch a
    tick;
17. ``unified_1000``: the same fleet and trace under ICO-F with the
    proactive ICO-F loop, both on one ``ForecastService`` (the loop every
    40 ticks): ticks/s beside phases 4 and 15, host ms of the forecast
    phase per step, nodes with a trusted pod at the end, proactive flags
    and actions, one ``runqlat_hist`` launch a tick, the forecaster's
    tensors on the card;
18. ``scheduler_latency`` (through
    ``benchmarks/bench_torch_scheduler_latency.py``): mean and p99
    admission latency of the five schedulers at 128 / 1,000 / 5,000
    nodes, 40 repetitions after a warm call, JAX's CI bound asserted (ICO
    and ICO-F at 5,000 nodes within 10x of their 128-node p99); ICO's and
    HUP's admissions at 5,000 nodes profiled; then ``--timers``: 30
    windows of the proactive loop on 8 nodes, its phase split, one
    ``runqlat_hist`` launch a tick;
19. ``rollout_scale`` (through ``benchmarks/bench_torch_rollout_scale.py``):
    the bench's 1,000-node 0.1-day sample (2 seeds) and a 12-node row cut
    to ``ROLLOUT_SCALE_DAYS`` (20 seeds), cold and warm, windows/s and
    node-ticks/s, one ``rollout_tick`` launch per batched tick;
20. ``flash_attention`` against its plain version: the bf16 wgmma/TMA
    kernel at zamba2-1.2b's prefill shapes (B 4, S 1024, H 32, hd 64,
    causal), at hd 128 and at a ragged GQA shape (S 1000, 9 heads over 3 KV
    heads, window 100); the float32 3xTF32 kernel at that ragged shape
    with and without the window; each timed beside the plain version,
    PyTorch's ``scaled_dot_product_attention`` and the earlier SIMT kernel
    on the same inputs, its bound the largest of bytes, products and
    exponentials;
21. ``ssd`` against its plain version (y and final state): the bf16
    tensor-core kernel at the same prefill's shapes (B 4, T 1024, H 64, P
    64, N 64), at a ragged T of 1000 and at the served smoke model's width
    (H 2, P 64, N 16), two calls bit-equal; each timed beside the plain
    version and the earlier SIMT kernel on the same inputs (CUDA events and
    device time from CUDA graphs);
22. the serving path at full width: zamba2-1.2b (1.17 B parameters, random
    bf16 weights from a generator seeded 0) behind ``ServeEngine(max_batch
    =4)``, 8 requests (two cohorts) with prompts of 256-1,024 tokens and
    16 new tokens each, both kernels' counts set to 0 before and read
    after; then one
    cohort's prefill with ``use_kernels=False`` against the kernel path,
    in bf16 and with the same weights in float32 (the 3xTF32 flash
    kernel's count set to 0 before and read after), prefill(x[:-1]) +
    decode(x[-1]) against the full forward (kernel and plain paths), and a
    profile of one cohort's prefill and of eight decode steps (device
    time, busy share, the flash kernels' share of the device time);
23. ``wkv`` (y and final state) against its plain version at rwkv6-7b's
    prefill shapes (B 4, T 1024, H 64, P 64, float32) at the served decay
    0.302 (where the chunked form's 1e-30 floors bind) and at real decays
    (also against the naive recurrence), at T 100 and 910 (chunks of 100
    and 65) and at P 16, timed beside the plain version and the earlier
    serial-chunk kernel;
24. the same serving path for rwkv6-7b at full width on 8 of its 32
    layers (``RWKV6_SERVE_LAYERS``, to keep the script near 800 s),
    prompts of 256-1,024 tokens in multiples of 64, the ``wkv`` count set
    to 0 before and read after (8 launches per cohort, none at decode),
    the same checks (prefill + decode against the forward over a cohort's
    first 64 tokens) and profiles;
25. ``flash_widths``: ``flash_attention`` against its plain version at
    every head width beyond 64 and 128, in both dtypes (hd 8, 16, 80, 256
    at B 2, S 1000, H 8 over KV 4; float32 at 64 and 128 too), and at
    gemma3-4b's prefill (B 4, S 2048, H 8 over 4, hd 256, bf16) for its
    global layer (causal) and its local one (window 1,024), each timed
    beside the plain version, SDPA and the SIMT kernel
    (``csrc/flash_attention.cu``) on the same inputs; bf16 must route to
    the wgmma kernel, float32 to the 3xTF32 one;
26-30. the same serving path (``SERVE_FAMILIES``) for gemma3-4b (17 of
    34 layers, prompts of 1,025-2,048 tokens so that its window binds),
    internlm2-20b and deepseek-coder-33b (12 of 48 and 12 of 62 layers;
    the whole models, 19.86 B and 33.34 B parameters, ran before the
    depths were cut to keep the script near 800 s), qwen3-moe-235b-a22b
    (full width, 8 of 94 layers) and dbrx-132b (6 of 40), one flash launch
    per layer per cohort and none at decode, one 3xTF32 flash launch per
    layer of the float32 copy's kernel prefill; before each, what earlier
    phases hold on the card must be under 2 GB (phases 2-19 run inside
    ``cluster_paths`` and release theirs when it returns).  The float32
    kernel-vs-plain copy is the first two layers for the three large
    models; an MoE's plain run is held to the kernel run's routing
    (``PinnedRouting``), the tokens that would route otherwise reported;
31. ``serve_qwen2vl`` (before it and before 32, the same < 2 GB check):
    qwen2-vl-72b at full width on its first 10 of 80 layers (10.02 B
    parameters, ~20.0 GB of bf16 weights; the full config's parameter
    count checked against JAX's 71,459,676,160), driven
    through ``prefill`` and ``decode_step`` (the engine takes token prompts
    only): two cohorts of 4 requests of seeded embeddings at S 1,024 and
    512, each a 448 x 448 image (a 16 x 16 grid of merged patches at t 0,
    h = row, w = col) then text from position 16 on, so the three M-RoPE
    streams differ; 16 decode steps fed seeded embeddings, the greedy
    tokens reported; 10 flash launches a prefill (hd 128, 64 query heads
    over 8 KV heads), none at decode; the kernel path against the plain
    path in bf16 and on a float32 copy of the first 2 layers (2 3xTF32
    launches), prefill + decode against the forward at equal-stream
    positions, profiles of one prefill and 8 decode steps;
32. ``encode_hubert``: hubert-xlarge's bidirectional encoder at full
    width and depth (48 layers, 1.259 B parameters, JAX's count checked):
    5 timed forwards of B 8 x S 1,000 seeded frame embeddings (20 s of
    audio at 50 frames/s) to (8, 1,000, 504) logits, 48 non-causal flash
    launches each (hd 80); the kernel path against the plain path in bf16
    and on a float32 copy of the whole model (48 3xTF32 launches);
    prefill's last logits against the forward's last row; a profile of one
    forward; then the non-causal flash case at that shape (B 8, S 1,000, H
    16, hd 80) in bf16 and float32 beside SDPA and the plain version;
33. ``flash_bwd_kernel``: the backward flash kernels (bf16
    ``csrc/flash_attention_bwd_sm90.cu``, float32
    ``csrc/flash_attention_bwd_f32_sm90.cu``, three launches a call, from
    the forward kernel's lse, which is held against the plain lse, its out
    bit-equal to a call without lse) against
    ``flash_attention_bwd_plain`` (dq, dk, dv) at smollm-135m's train
    shape (B 8, S 1,024, H 9 over 3, hd 64, causal), hubert-xlarge's (B
    8, S 1,000, H 16, hd 80, non-causal), ``main_hd128`` (B 4, S 1,024, H
    16, hd 128) and the attention of the last three families trained (B 4,
    S 1,024: qwen3-moe's 64 heads over 4, GQA group 16, hd 64; dbrx's 48
    over 8, group 6, hd 128; qwen2-vl's 64 over 8, group 8, hd 128), each
    in bf16 and float32, and a windowed case (window 100) at hd 64; two
    launches bitwise equal; each timed beside the plain version, SDPA's
    backward (``torch.autograd.grad``, timed only) and, at the first seven,
    the SIMT kernel they replaced (``csrc/flash_attention_bwd.cu`` through
    its own entry, held to the plain version too), its and the SIMT
    kernel's device times from CUDA graphs, and its bound;
34. ``train_smollm``: smollm-135m at full size (134.5 M parameters,
    random weights seeded 0) trained by ``launch.train.train_loop`` for
    20 steps on ``SyntheticLM(seq 1,024, global batch 8, seed 0)`` with
    remat, accum 2, int8 compression and lr 6e-4 with the launcher's
    warmup; both flash counts set to 0 before and read after (2,400
    forward launches, 3,600 backward ones, all on the wgmma libraries);
    the loss must fall (last five steps' mean below the first five's) and
    stay finite; step ms,
    tokens/s, peak memory, one more step profiled (busy share, kernels,
    the backward kernel's share of device time); a float32 copy of the
    whole model, on one batch, its gradients through the kernels against
    the plain path's (60 3xTF32 forward launches, 90 backward ones): the
    backward kernel within 1e-4 of each leaf's largest value against the
    plain backward, on the plain forward and on the kernel forward, the
    whole kernel path within 1e-2 (the 3xTF32 forward's rounding,
    amplified by the trained model's wq / wk gradients);
35. ``ssd_bwd_kernel``: the SSD backward kernel
    (``csrc/ssd_bwd_sm90.cu``, four launches a call) against
    ``ssd_bwd_plain`` (dx, ddt, dA, dB, dC) at zamba2-1.2b's train
    microbatch (B 4, T 1,024, H 64, P 64, N 64) in bf16 and float32, at a
    ragged T of 1,000 and at the smoke width (H 8, P 16, N 16), the last
    two with a final-state gradient; A = -linspace(1, 16, H), where JAX's
    own gradient is NaN; two calls bitwise equal; timed beside the plain
    version (CUDA events; device time from CUDA graphs), its bound the
    larger of bytes and the backward's least products;
36. ``wkv_bwd_kernel``: the WKV backward kernel (``csrc/wkv_bwd.cu``, four
    launches a call) against ``wkv_bwd_plain`` (dr, dk, dv, dw, du) at
    rwkv6-7b's train microbatch (B 4, T 1,024, H 64, P 64, chunks of 64)
    at the default init's decay 0.302 (the 1e-30 floor binds, JAX's own
    gradient is NaN) and at real decays with a final-state gradient, at
    the smoke width (H 4, P 16), and at rwkv6-7b's width at T 160 (JAX's
    rule: two chunks of 80 steps) at both decays; the same checks and
    times;
37. ``train_zamba2``: zamba2-1.2b at full size (38 layers, d 2,048, 64 SSD
    heads of P 64, N 64, the shared attention block six times; 1.17 B
    parameters, random weights seeded 0) trained by ``train_loop`` for 10
    steps on ``SyntheticLM(seq 1,024, global batch 8, seed 0)``, remat,
    accum 2, int8 compression, lr 6e-4; the SSD and flash counts set to 0
    before and read after (SSD forward 1,480: twice a layer a microbatch
    under remat, once in the two-layer tail; backward 3,040: four a layer
    a microbatch; flash 240 and 360 for the six shared-block
    applications); the loss finite and falling; step ms, tokens/s, peak
    memory, one more step profiled (busy share, the SSD backward's share
    of device time); on one microbatch a float32 copy's gradients with
    the SSD scan's directions swapped (``kernels.scan_function``): the
    backward kernel against ``ssd_bwd_plain`` on the plain and on the
    kernel forward, the forward kernel alone, and both kernels against
    both plain versions, each within 1e-4 of each leaf's largest value
    (autograd through the plain scan is NaN here, as JAX's);
38. ``train_rwkv6``: rwkv6-7b at full width (d 4,096, 64 heads of 64,
    d_ff 14,336, vocab 65,536) on its first 4 of 32 layers (1.41 B
    parameters; the whole model with AdamW's state would not fit one
    card), the same loop and checks (WKV forward 160, backward 320);
39-41. ``train_qwen3moe``, ``train_dbrx``, ``train_qwen2vl``
    (``TRAIN_FAMILIES``): qwen3-moe-235b-a22b, dbrx-132b and qwen2-vl-72b
    at full width (d_model, heads, KV heads, head_dim, per-expert d_ff,
    vocabulary and top-k as published) on their first layer, the MoE on
    64 of 128 and 8 of 16 experts (one card does not hold more with
    AdamW's state); the loop and checks of
    38 (flash forward 40 and backward 60 launches, all on the wgmma
    libraries), peak memory under 90% of the card, a profiled step with
    the flash kernels' and the MoE dispatch's shares of device time, an
    MoE's gradients of one microbatch twice from the same weights
    compared bit for bit, and a float32 copy on half a microbatch (2 x
    1,024) with the flash directions swapped: the backward kernel alone
    and on the kernel forward within 1e-4 of each leaf's largest value,
    the whole kernel path within 1e-2 (an MoE's runs on the first run's
    routing, layer by layer through remat's recomputes, the tokens it moved
    reported; qwen2-vl's at a 16 x 16 image's grid positions then text, so
    its three M-RoPE streams differ; its training batches are the
    launcher's);
42. ``metric_pipeline``: ``benchmarks/bench_torch_metric_pipeline.py`` at
    1,000 and 4,000 nodes x 14 x 256 samples (CUDA events), every sample
    binned once, the histograms equal to the plain version's;
43. ``colocation``: ``examples/torch_colocation_sim.py`` ``--selftest``
    and its demo on the card (ICO places 14 pods, the smollm smoke model
    serves 8 requests through the wgmma flash kernel (hd 16), Eq. 1 of its
    runqlat histogram).

Then it prints the card's name and power limit, one JSON line of kernel
numbers, and last ``{"ok": true, "device": {...}}``.  Any failure raises
and exits non-zero; without a card it exits 1 before doing anything.
"""
import copy
import ctypes
import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_OPS_PER_S = 67e12           # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # bf16 dense tensor cores
TF32_OPS_PER_S = 495e12          # TF32 dense tensor cores
# float32-accurate products on the tensor cores: 3xTF32 spends three TF32
# products on each
F32_3XTF32_OPS_PER_S = TF32_OPS_PER_S / 3
EX2_PER_CLOCK_SM = 16            # MUFU exponentials, compute capability 9.0
MIX = {"std32": 6, "hi96": 1, "lo16": 3}


def say(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def cuda_ms(fn, iters=200, warmup=20):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, calls=20, replays=10):
    """Mean device milliseconds per call of ``fn``: ``calls`` calls
    captured in one CUDA graph, replayed ``replays`` times between CUDA
    events.  Unlike ``cuda_ms`` this leaves out the host's time between
    launches, which sets the events' time for a kernel shorter than its
    wrapper call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


EARLIER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                       "earlier")


def earlier_runqlat_hist(torch, build, card):
    """The earlier ``runqlat_hist`` kernel (``tools/earlier/runqlat_hist.cu``:
    one launch per set, 32 series a block in shared memory), built from its
    source, as a function of one contiguous (samples, weights) set."""
    import ctypes

    fn = build.load("runqlat_hist", EARLIER).runqlat_hist_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(s, w):
        out = torch.empty((s.shape[0], 200), device=card)
        dev, stream = build.device_and_stream(s)
        spb = max(1, min(32, 2048 // max(s.shape[1], 1)))
        err = fn(s.data_ptr(), w.data_ptr(), out.data_ptr(), s.shape[0],
                 s.shape[1], spb, dev, stream)
        if err:
            raise RuntimeError(f"earlier runqlat_hist launch failed: {err}")
        return out
    return run


def phase_kernel(torch, K, build, card):
    """``runqlat_hist`` against its plain version on the card, at the sets
    one 1,000-node tick gives it (8,000 online and 6,000 offline series of
    16, 0/1 slot masks broadcast along the samples), through the one-launch
    entry as ``_tick`` calls it; general float weights at n 16 (against
    the CPU's sequential plain version, bit for bit) and on a ragged long
    shape (to float32 rounding).  Then device times from CUDA graphs (no
    host time): this kernel's one launch for both sets against the earlier
    kernel's two on the same inputs (order earlier, this, this, earlier),
    the plain version's and ``scatter_add_``'s; and the wrapper call by
    CUDA events (with its host time)."""
    g = torch.Generator(device=card).manual_seed(0)
    sets = []
    for slots in (8, 6):
        s = torch.rand((1000, slots, 16), generator=g, device=card) \
            * 1210.0 - 10.0
        m = (torch.rand((1000, slots), generator=g, device=card) < 0.6)
        sets.append((s.reshape(-1, 16),
                     m.float()[..., None].expand(1000, slots, 16)
                     .reshape(-1, 16)))
    before = K.launches
    got = K.runqlat_hist_segments(sets)
    torch.cuda.synchronize()
    if K.launches - before != 1:
        raise AssertionError(f"{K.launches - before} launches for two sets")
    for (s, w), h in zip(sets, got):
        if w.stride(1) != 0:
            raise AssertionError("the mask weights were materialised")
        want = K.runqlat_hist_plain(s, w)
        if not torch.equal(h, want) or not torch.equal(
                h, K.runqlat_hist(s, w.contiguous())):
            raise AssertionError(f"runqlat_hist != plain at {tuple(s.shape)}")
        if not torch.equal(h.sum(-1), w.sum(-1)):
            raise AssertionError("zero weights leaked into the histogram")
    # general float weights, short series: the warp sums in sample order,
    # so it equals the CPU's sequential scatter-add bit for bit
    s = torch.rand((3001, 16), generator=g, device=card) * 1210.0 - 10.0
    w = torch.rand((3001, 16), generator=g, device=card)
    w = w * (torch.rand((3001, 16), generator=g, device=card) < 0.8)
    if not torch.equal(K.runqlat_hist(s, w).cpu(),
                       K.runqlat_hist_plain(s.cpu(), w.cpu())):
        raise AssertionError("float weights at n 16 != sequential plain")
    # ragged long series, general float weights (with zeros): shared
    # atomics add in no fixed order, so this agrees to float32 rounding
    s = torch.rand((64, 5003), generator=g, device=card) * 1210.0 - 10.0
    w = torch.rand((64, 5003), generator=g, device=card)
    w = w * (torch.rand((64, 5003), generator=g, device=card) < 0.8)
    got, want = K.runqlat_hist(s, w), K.runqlat_hist_plain(s, w)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-4):
        raise AssertionError(f"ragged float-weight case: max err {err}")
    say("kernel-check", main_path_equal=True, launches_for_both_sets=1,
        float_weights_n16_equal_sequential=True, ragged_shape="64x5003",
        ragged_max_abs_err=err)

    earlier = earlier_runqlat_hist(torch, build, card)
    dense = [(s, w.contiguous()) for s, w in sets]
    for (s, w), h in zip(dense, K.runqlat_hist_segments(sets)):
        if not torch.equal(earlier(s, w), h):
            raise AssertionError("earlier kernel != this kernel")
    idx = [torch.clamp(torch.floor(s / 5.0), 0, 199).long() for s, _ in sets]

    def this():
        return K.runqlat_hist_segments(sets)

    def earlier_two():
        return [earlier(s, w) for s, w in dense]

    def plain():
        return [K.runqlat_hist_plain(s, w) for s, w in sets]

    def library():
        return [torch.zeros((s.shape[0], 200), device=card).scatter_add_(
            1, i, w) for (s, w), i in zip(sets, idx)]

    dev = {}
    for name, fn in (("earlier", earlier_two), ("kernel", this),
                     ("kernel2", this), ("earlier2", earlier_two),
                     ("plain", plain), ("library", library)):
        dev[name] = graph_ms(torch, fn)
    calls = _timed([("kernel_call", this), ("earlier_calls", earlier_two),
                    ("plain", plain), ("library", library)])
    # each input read once: the samples, one 0/1 weight a series (the
    # kernel reads the broadcast mask where it lies); the histograms out
    rows = sum(s.shape[0] for s, _ in sets)
    nbytes = 4 * (sum(s.numel() for s, _ in sets) + rows + rows * 200)
    nops = sum(6 * s.numel() for s, _ in sets)  # div, floor, 2 clamps, cast, add
    bound_ms = max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S) * 1e3
    kernel_ms = min(dev["kernel"], dev["kernel2"])
    say("kernel-time", per_tick_sets="8000x16+6000x16", bytes=nbytes,
        kernel_device_ms=kernel_ms,
        earlier_device_ms=min(dev["earlier"], dev["earlier2"]),
        plain_device_ms=dev["plain"], library_device_ms=dev["library"],
        kernel_call_ms=calls["kernel_call"],
        earlier_calls_ms=calls["earlier_calls"], plain_call_ms=calls["plain"],
        library_call_ms=calls["library"], bound_ms=bound_ms,
        device_runs=json.dumps(dev))
    return dict(ms=kernel_ms, plain_ms=dev["plain"],
                library_ms=dev["library"], bound_ms=bound_ms,
                max_abs_err=err)


def ptxas_summary(log):
    """Registers, shared memory and spills of each entry ptxas compiled
    (``-Xptxas -v``), keyed by the entry's (mangled) name."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\w+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(sm.group(1)) if sm else 0
    return out


FLASH_WIDTHS = ["hd128", "hd16", "hd256", "hd64", "hd8", "hd80"]


def flash_instantiations(log, kernel="flash_sm90_kernel"):
    """ptxas's numbers for each instantiation of ``kernel`` (the wgmma
    kernel, or ``flash_f32_kernel``), keyed by its head width (the mangled
    name's first template argument; the second, where there is one, is
    the tiles' width)."""
    import re

    out = {}
    for entry, nums in ptxas_summary(log).items():
        m = re.search(kernel + r"ILi(\d+)E(?:Li(\d+)E)?", entry)
        if m:
            tile = {"tile_width": int(m.group(2))} if m.group(2) else {}
            out[f"hd{m.group(1)}"] = dict(**tile, **nums)
    return out


def sass_count(path, opcode):
    """How many instructions of ``opcode`` ``cuobjdump -sass`` finds in the
    library at ``path``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = os.path.join(home, "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    # an instruction line: /*addr*/  OPCODE operands ;  /* encoding */
    return sum(opcode in line.split("*/", 1)[1].split("/*")[0]
               for line in sass.splitlines()
               if line.strip().startswith("/*") and "*/" in line)


def loaded_cluster(Cluster, make_fleet, Pod, W, num_nodes, device, seed=0):
    """A fleet cluster with online and offline pods on most nodes."""
    import numpy as np

    c = Cluster(fleet=make_fleet(num_nodes, MIX, seed=0), seed=seed,
                device=device)
    rng = np.random.default_rng(seed)
    for i in range(4 * num_nodes):
        if rng.random() < 0.6:
            name = str(rng.choice(W.ONLINE_NAMES))
            pod = Pod(name, float(rng.uniform(50, 900)), True)
        else:
            name = str(rng.choice(W.OFFLINE_NAMES))
            pod = Pod(name, 0.0, False, duration=int(rng.integers(3, 40)))
            pod.cpu_demand = float(rng.choice([2, 4, 8]))
        c.place(pod, int(rng.integers(num_nodes)))
    return c


def device_profile(torch, fn, per, unit):
    """Run ``fn()`` once under ``torch.profiler``: wall ms, device time and
    kernel launches per ``unit`` (``per`` units in the run), the device's
    busy share, the share of device time in the flash kernels, and the top
    six kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in rows)
    flash_us = sum(e.self_device_time_total for e in rows
                   if "flash" in e.key)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    return {f"profiled_ms_per_{unit}": wall_s * 1e3 / per,
            "device_busy_share": device_us * 1e-6 / wall_s,
            f"device_us_per_{unit}": device_us / per,
            "flash_device_share": flash_us / device_us if device_us else 0.0,
            f"kernels_per_{unit}": sum(e.count for e in rows) / per,
            "top": json.dumps([[e.key[:48], e.self_device_time_total / per,
                                e.count / per] for e in top])}


def phase_profile(torch, K, c, sched, pods, ticks=100):
    """Where time goes at 1,000 nodes: host ms and ``runqlat_hist``
    launches per tick, then one rollout under ``torch.profiler`` for the
    device's busy share and its kernels, then host ms per admission (one
    view and one ICO decision)."""
    c.rollout(20)                                   # warm the path
    torch.cuda.synchronize()
    before = K.launches
    t0 = time.perf_counter()
    c.rollout(ticks)
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) * 1e3 / ticks
    per_tick = (K.launches - before) / ticks
    if per_tick != 1:
        raise AssertionError(f"{per_tick} runqlat_hist launches a tick")
    say("profile", ticks=ticks, host_ms_per_tick=tick_ms,
        runqlat_hist_launches_per_tick=per_tick,
        **device_profile(torch, lambda: c.rollout(ticks), ticks, "tick"))
    t0 = time.perf_counter()
    for pod in pods:
        sched.select_node(pod, c.view())
    say("profile", admissions=len(pods),
        host_ms_per_admission=(time.perf_counter() - t0) * 1e3 / len(pods))


def to_device(dev, obj):
    """A frozen dataclass of tensors (state, fleet, noise bundle) on dev."""
    return type(obj)(**{k: v.to(dev) for k, v in vars(obj).items()})


def phase_engine_parity(torch, cstate, texp, plan, card, seeds=(0, 1, 2)):
    """The batched engine on a 12-node plan: fused tick against the default
    tick on the card, then the fused engine on the card against the CPU,
    every run on the same draws."""
    cpu = torch.device("cpu")
    inp = texp.replay_inputs(plan, device=card)
    chunks = inp["padded_windows"] * inp["cpw"]
    streams = []
    for s in seeds:
        gen = torch.Generator(device=card).manual_seed(100 + s)
        streams.append([cstate.draw_noise(gen, inp["num_nodes"], cstate.CHUNK)
                        for _ in range(chunks)])

    def run(inp, streams, fused):
        return cstate.batched_rollout(
            inp["state"], inp["profiles"], 0.0, streams, inp["events"],
            fleet=inp["fleet"], use_fused=fused)

    gf_final, gf = run(inp, streams, True)
    _, gd = run(inp, streams, False)
    for k in ("hot", "qps", "cpu_util", "mem_util"):
        if not torch.equal(gf[k], gd[k]):
            raise AssertionError(f"engine {k}: fused != default tick")
    if not torch.allclose(gf["rt"], gd["rt"], rtol=1e-5, atol=1e-5):
        raise AssertionError("engine rt: fused != default tick")
    fused_rel = float(((gf["rt"] - gd["rt"]).abs()
                       / gd["rt"].abs().clamp_min(1e-5)).max())

    cinp = texp.replay_inputs(plan, device=cpu)
    cstreams = [[[to_device(cpu, n) for n in ch] for ch in st]
                for st in streams]
    cf_final, cf = run(cinp, cstreams, True)
    for k, v in vars(gf_final["state"]).items():
        if not torch.equal(v.cpu(), getattr(cf_final["state"], k)):
            raise AssertionError(f"engine state {k}: card != cpu")
    if not torch.equal(gf["hot"].cpu(), cf["hot"]):
        raise AssertionError("engine hot: card != cpu")
    worst = 0.0
    for k in ("rt", "qps", "cpu_util", "mem_util"):
        a, b = gf[k].cpu(), cf[k]
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"engine {k}: card != cpu")
        worst = max(worst, float(((a - b).abs()
                                  / b.abs().clamp_min(1e-5)).max()))
    return dict(seeds=len(seeds), nodes=inp["num_nodes"],
                batched_ticks=chunks * cstate.CHUNK,
                hot_windows=int(gf["hot"].any(-1).sum()),
                fused_vs_default_rt_max_rel=fused_rel,
                card_vs_cpu_max_rel=worst)


def _tick_rows(args, rows):
    """``fused_tick_unpacked`` arguments cut to their first ``rows`` rows
    (views: the strides stay those of the replay's tensors)."""
    fields, *rest = args
    return [[f[:rows] for f in fields]] + [t[:rows] for t in rest]


def phase_fused_kernel(torch, RT, args, card):
    """``rollout_tick`` (the unpacked entry the replay calls) against its
    plain version on one batched tick of the replay (R = 20,000) and a
    ragged R = 37, then its time beside the plain version's and beside the
    packing the kernel needed before (``pack`` then the packed entry)
    (order plain, kernel, kernel, plain, packed)."""
    worst_rel, max_err = 0.0, 0.0
    for name, inp in (("main", args), ("ragged", _tick_rows(args, 37))):
        got = RT.fused_tick_unpacked(*inp)
        want = RT.fused_tick_unpacked_plain(*inp)
        torch.cuda.synchronize()
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"rollout_tick hist != plain ({name})")
        act = torch.cat([inp[3], inp[4]], 1).float()
        if not torch.equal(got[0].sum(-1), act.sum(-1) * 16):
            raise AssertionError(f"rollout_tick totals != 16 x active ({name})")
        for a, b in zip(got[1:], want[1:]):
            rel = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
            worst_rel = max(worst_rel, rel)
            max_err = max(max_err, float((a - b).abs().max()))
        if worst_rel > 1e-6:
            raise AssertionError(f"rollout_tick delay/mean rel {worst_rel}")
    rows, slots = args[0][0].shape[0], args[1].shape[1] + args[2].shape[1]
    k = args[5].shape[2]
    active = int(args[3].count_nonzero() + args[4].count_nonzero())
    # each input read once, each output written once: the eight fields,
    # the jitter normals and bool masks of every slot, the uniforms of the
    # active slots only; histogram, delay and means out
    out_bytes = 4 * rows * (200 + 1 + slots)
    data_bytes = (4 * rows * 8 + 5 * rows * slots + 4 * 2 * active * k
                  + out_bytes)
    nops = 12 * active * k + 16 * rows + 3 * rows * slots  # per sample: 2
    # mul, log, div, mul, div, floor, 2 clamps, cast, add; the delay curve
    # a row; the jitter and mean a slot
    bound_ms = max(data_bytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S) * 1e3
    packed = RT.pack(*args)
    ms = _timed([("plain", lambda: RT.fused_tick_unpacked_plain(*args)),
                 ("kernel", lambda: RT.fused_tick_unpacked(*args)),
                 ("kernel2", lambda: RT.fused_tick_unpacked(*args)),
                 ("plain2", lambda: RT.fused_tick_unpacked_plain(*args)),
                 ("packed_kernel", lambda: RT.fused_tick(*packed)),
                 ("pack_and_packed_kernel",
                  lambda: RT.fused_tick(*RT.pack(*args)))])
    # the kernel is shorter than its wrapper call, so the events time the
    # host: the kernel's own time is taken from a CUDA graph of calls
    dev = {"kernel": graph_ms(torch, lambda: RT.fused_tick_unpacked(*args)),
           "packed_kernel": graph_ms(torch, lambda: RT.fused_tick(*packed)),
           "pack_and_packed_kernel": graph_ms(
               torch, lambda: RT.fused_tick(*RT.pack(*args))),
           "plain": graph_ms(torch,
                             lambda: RT.fused_tick_unpacked_plain(*args))}
    return dict(rows=rows, active_slots=active, max_rel_err=worst_rel,
                max_abs_err=max_err, data_bytes=data_bytes,
                bound_ms=bound_ms, ms=dev["kernel"], plain_ms=dev["plain"],
                call_ms=min(ms["kernel"], ms["kernel2"]),
                plain_call_ms=min(ms["plain"], ms["plain2"]),
                device_ms=json.dumps(dev), call_runs=json.dumps(ms))


def capture_replay_tick(torch, cstate, texp, RT, plan, seeds, tick, card):
    """The ``rollout_tick`` inputs of the replay's ``tick``-th batched tick
    (counted from 1): the replay's first windows rerun, untimed, with the
    kernel's wrapper wrapped to keep that call's arguments."""
    inp = texp.replay_inputs(plan, device=card)
    windows = -(-tick // inp["span"])
    grab: dict = {"calls": 0}
    real_fused_tick = RT.fused_tick_unpacked

    def keep_one_tick(fields, *args, **kw):
        grab["calls"] += 1
        if grab["calls"] == tick:   # clones keep the strides of the views
            grab["args"] = [[keep(f) for f in fields]] + [keep(a)
                                                          for a in args]
        return real_fused_tick(fields, *args, **kw)

    def keep(t):
        return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                   device=t.device).copy_(t)

    RT.fused_tick_unpacked = keep_one_tick
    try:
        cstate.batched_rollout(
            inp["state"], inp["profiles"], 0.0,
            [cstate.SeedNoise(s, inp["num_nodes"], card) for s in seeds],
            {k: v[:windows] for k, v in inp["events"].items()},
            fleet=inp["fleet"], use_fused=True)
    finally:
        RT.fused_tick_unpacked = real_fused_tick
    return grab["args"]


def phase_replay_profile(torch, cstate, texp, RT, plan, card, seeds=20,
                         windows=2):
    """The batched tick at 20 seeds x 1,000 nodes, from the plan's final
    occupancy (every event applied, no expiry): host ms per batched tick
    without the profiler, then under ``torch.profiler`` the device's busy
    share, kernels per tick and the top kernels; fused, then default."""
    inp = texp.replay_inputs(plan, device=card)
    state = inp["state"]
    ev = inp["events"]
    for w in range(ev["op"].shape[0]):
        for c in range(inp["cpw"]):
            state = cstate.apply_events(state, {k: v[w, c]
                                                for k, v in ev.items()})
    ticks = windows * inp["span"]
    out = {}
    for fused in (True, False):
        def run(n_windows):
            return cstate.batched_rollout(
                state, inp["profiles"], 0.0,
                [cstate.SeedNoise(s, inp["num_nodes"], card)
                 for s in range(seeds)],
                cstate.extract_plan([], 0.0, n_windows, inp["cpw"]),
                fleet=inp["fleet"], use_fused=fused)

        run(1)                                       # warm the path
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(windows)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / ticks
        before = RT.launches
        prof = device_profile(torch, lambda: run(windows), ticks,
                              "batched_tick")
        out["fused" if fused else "default"] = dict(
            host_ms_per_batched_tick=host_ms, **prof,
            rollout_tick_launches_per_tick=(RT.launches - before) / ticks)
    return out


def _close(torch, got, want, rtol, atol, what):
    """Max abs error of got against want; raises past rtol/atol."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: max abs err {err} past rtol {rtol} "
                             f"atol {atol}")
    return err


def _timed(fns):
    """CUDA-event times of each named call, in the order given."""
    return {name: cuda_ms(fn) for name, fn in fns}


# bf16 outputs: kernel and plain version round float32 values that differ
# in their last bits, so they agree to a bf16 ulp; float32 to summation order
KERNEL_TOL = {"bfloat16": (1e-2, 1e-2), "float32": (2e-5, 2e-5)}


@functools.cache
def ex2_per_s(torch):
    """Exponentials a second on the card's special-function units: 16 a
    clock an SM at the max SM clock ``nvidia-smi`` reports (read once)."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return EX2_PER_CLOCK_SM * sms * float(mhz) * 1e6


def _simt_flash(torch, FA, build, q, k, v, causal, window):
    """The SIMT kernel (``csrc/flash_attention.cu``) on q's dtype, called
    through its own entry: the port routes no pair to it since the wgmma
    and 3xTF32 kernels replaced it, and this keeps the earlier kernel's
    time beside the new ones in the same run."""
    fn = FA._entry(FA.SIMT)
    out = torch.empty_like(q)
    B, S, H, hd = q.shape

    def run():   # on the current stream, which a graph capture sets
        dev, stream = build.device_and_stream(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                 S, H, k.shape[2], hd, int(causal), window,
                 FA._DTYPES[q.dtype], dev, stream)
        if err:
            raise RuntimeError(f"SIMT flash launch failed: {err}")
        return out
    return run


def _flash_case(torch, FA, build, g, card, name, B, S, H, KV, hd, dtype,
                window, iters=200, causal=True):
    """One shape: the wrapper's kernel against the plain version (causal,
    ``window`` 0 or a sliding window; or with ``causal`` False every key),
    each timed beside the plain version and SDPA (order plain, kernel,
    kernel, plain, library: ``is_causal`` as ``causal`` without a window, a
    boolean window mask with one), and the SIMT kernel these replaced on
    the same inputs.  The bound is the largest of three
    times: q, k, v and o once over the memory rate; the products of the
    (query, key) pairs the masks keep over the bf16 tensor cores' rate, or
    in float32 the TF32 rate spread over 3xTF32's three products; one
    exponential a kept pair over the special-function units' rate.
    ``bound_by`` says bytes or operations, ``bound_term`` which term; a
    float32 shape also gives the earlier bound with its products on the
    float32 CUDA cores (``cuda_core_bound_ms``).  The kernel, the SIMT
    kernel and SDPA are also timed from CUDA graphs (``*_device_ms``: no
    host time, which sets the events' time of a call of tens of µs)."""
    import torch.nn.functional as F

    q, k, v = (torch.randn((B, S, h, hd), generator=g, device=card,
                           dtype=torch.float32).to(dtype)
               for h in (H, KV, KV))
    got = FA.flash_attention(q, k, v, causal=causal, sliding_window=window)
    want = FA.flash_attention_plain(q, k, v, causal=causal,
                                    sliding_window=window)
    torch.cuda.synchronize()
    rtol, atol = KERNEL_TOL[str(dtype).split(".")[-1]]
    err = _close(torch, got, want, rtol, atol, f"flash {name}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    i = torch.arange(S, device=card)
    keep = ((i[:, None] >= i[None, :]) | (not causal)) & (
        i[None, :] > i[:, None] - window - 1 if window else True)
    sdpa = dict(is_causal=causal) if not window else dict(attn_mask=keep)
    kw = dict(causal=causal, sliding_window=window)
    fns = [
        ("plain", lambda: FA.flash_attention_plain(q, k, v, **kw)),
        ("kernel", lambda: FA.flash_attention(q, k, v, **kw)),
        ("kernel2", lambda: FA.flash_attention(q, k, v, **kw)),
        ("plain2", lambda: FA.flash_attention_plain(q, k, v, **kw)),
        ("library", lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=KV != H, **sdpa))]
    kernel = FA.route(dtype, hd)
    simt = _simt_flash(torch, FA, build, q, k, v, causal, window)
    simt_err = _close(torch, simt(), want, rtol, atol, f"SIMT flash {name}")
    fns.append(("simt", simt))
    del got, want
    ms = {n: cuda_ms(fn, iters=iters, warmup=max(2, iters // 10))
          for n, fn in fns}
    device = {f"{n}_device_ms": graph_ms(torch, fn, calls=max(2, iters // 10))
              for n, fn in fns if n in ("kernel", "simt", "library")}
    nbytes = q.element_size() * 2 * (q.numel() + k.numel())  # q,k,v; o
    pairs = int(keep.sum())                    # attended (query, key)
    nops = 4 * hd * B * H * pairs              # QK^T and PV
    f32 = dtype == torch.float32
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "products": nops / (F32_3XTF32_OPS_PER_S if f32
                                 else BF16_OPS_PER_S) * 1e3,
             "exponentials": B * H * pairs / ex2_per_s(torch) * 1e3}
    term = max(terms, key=terms.get)
    extra = {"cuda_core_bound_ms": max(terms["bytes"], terms["exponentials"],
                                       nops / FP32_OPS_PER_S * 1e3)} if f32 \
        else {}
    return dict(
        shape=f"B{B} S{S} H{H}/{KV} hd{hd} {dtype} window{window}"
              + ("" if causal else " non-causal"),
        kernel=kernel[0], max_abs_err=err, bytes=nbytes, flops=nops,
        bound_ms=terms[term],
        bound_by="bytes" if term == "bytes" else "operations",
        bound_term=term, bound_terms_ms=json.dumps(terms), **extra,
        ms=min(ms["kernel"], ms["kernel2"]),
        plain_ms=min(ms["plain"], ms["plain2"]),
        library_ms=ms["library"], simt_ms=ms["simt"],
        simt_max_abs_err=simt_err, **device, runs=json.dumps(ms))


# zamba2-1.2b's prefill, hd 128 at the same size, a ragged GQA shape
FLASH_CASES = [("main", 4, 1024, 32, 32, 64, "bfloat16", 0),
               ("main_hd128", 4, 1024, 16, 16, 128, "bfloat16", 0),
               ("ragged_bf16", 1, 1000, 9, 3, 64, "bfloat16", 100),
               ("ragged", 1, 1000, 9, 3, 64, "float32", 0),
               ("ragged_window", 1, 1000, 9, 3, 64, "float32", 100)]


def phase_flash_kernel(torch, FA, build, card):
    """``flash_attention`` against its plain version: bf16 (the wgmma/TMA
    kernel) at the serve phase's prefill shapes, at hd 128 and at a ragged
    GQA shape with a window; float32 (the 3xTF32 kernel) at the ragged
    shape with and without the window; each also timed through the
    earlier SIMT kernel on the same inputs."""
    g = torch.Generator(device=card).manual_seed(1)
    return {c[0]: _flash_case(torch, FA, build, g, card, *c[:6],
                              getattr(torch, c[6]), c[7])
            for c in FLASH_CASES}


# gemma3-4b's prefill (B 4, S 2,048, H 8 over KV 4, hd 256), its global and
# its local (window 1,024) layers, then the widths beyond 64 and 128 (the
# smoke configs' 8 and 16, hubert-xlarge's 80, gemma3's 256) in both dtypes
# and float32 at 64 and 128, at a ragged GQA shape
WIDTH_CASES = [("gemma3_global", 4, 2048, 8, 4, 256, "bfloat16", 0, 50),
               ("gemma3_local", 4, 2048, 8, 4, 256, "bfloat16", 1024, 50)] + [
    (f"hd{hd}_{dt}", 2, 1000, 8, 4, hd, dt, 0, 100)
    for hd in (8, 16, 80, 256) for dt in ("bfloat16", "float32")] + [
    (f"hd{hd}_float32", 2, 1000, 8, 4, hd, "float32", 0, 100)
    for hd in (64, 128)]


def phase_flash_widths(torch, FA, build, card):
    """``flash_attention`` at every head width beyond 64 and 128, and in
    float32 at 64 and 128 too, against the plain version, timed beside it,
    SDPA and the SIMT kernel (``_flash_case``): bf16 must route to the
    wgmma kernel (gemma3's layers among them), float32 to the 3xTF32 one;
    fewer timed calls at gemma3's shape, whose plain version takes ms."""
    g = torch.Generator(device=card).manual_seed(2)
    out = {}
    for name, B, S, H, KV, hd, dt, window, iters in WIDTH_CASES:
        out[name] = _flash_case(torch, FA, build, g, card, name, B, S, H, KV,
                                hd, getattr(torch, dt), window, iters)
        want = ("flash_attention_sm90" if dt == "bfloat16"
                else "flash_attention_f32_sm90")
        if out[name]["kernel"] != want:
            raise AssertionError(f"{name} routed to {out[name]['kernel']}")
    return out


def _ssd_flops(B, T, H, P, N, L=64):
    """The four chunk products' operations (the two triangular ones over
    the lower triangle), over whole chunks of L steps."""
    tri = L * (L + 1) // 2
    per_chunk = 2 * (2 * L * P * N + tri * N + tri * P)
    return B * H * -(-T // L) * per_chunk


# B, T, H, P, N: zamba2-1.2b's prefill, a ragged T, and the width of the
# served smoke model (P widened to 64 as tests/test_torch_cuda.py serves it)
SSD_CASES = [("main", 4, 1024, 64, 64, 64), ("ragged", 4, 1000, 64, 64, 64),
             ("smoke", 4, 200, 2, 64, 16)]


def _simt_ssd(torch, SSD, build, x, dt, A, Bm, Cm):
    """The SIMT kernel (``csrc/ssd.cu``) on bf16 inputs, called through the
    wrapper's float32 entry with the bf16 dtype code: the port routes bf16
    to the tensor-core kernel since it replaced this one, and this keeps
    the earlier kernel's time beside the new one in the same run."""
    fn = SSD._entry(torch.float32)
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((Bsz, H, P, N), device=x.device)

    def run():   # on the current stream, which a graph capture sets
        dev, stream = build.device_and_stream(x)
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(), state.data_ptr(), Bsz, T, H, P,
                 N, SSD._DTYPES[torch.bfloat16], dev, stream)
        if err:
            raise RuntimeError(f"SIMT ssd launch failed: {err}")
        return y, state
    return run


def phase_ssd_kernel(torch, SSD, build, card):
    """``ssd`` (y and final state) against its plain version: the bf16
    tensor-core kernel at the serve phase's prefill shapes, at a ragged T
    and at the smoke width; each also against the SIMT kernel on the same
    inputs.  Times: CUDA events over wrapper calls (order plain, kernel,
    kernel, plain, SIMT) and device time from CUDA graphs (kernel, SIMT,
    kernel)."""
    g = torch.Generator(device=card).manual_seed(2)
    out = {}
    for name, B, T, H, P, N in SSD_CASES:
        x = torch.randn((B, T, H, P), generator=g, device=card).bfloat16()
        dt = torch.rand((B, T, H), generator=g, device=card) * 0.19 + 0.01
        A = -torch.linspace(1.0, 16.0, H, device=card)   # as init_params
        Bm = torch.randn((B, T, N), generator=g, device=card).bfloat16()
        Cm = torch.randn((B, T, N), generator=g, device=card).bfloat16()
        args = (x, dt, A, Bm, Cm)
        y, state = SSD.ssd(*args)
        y2, state2 = SSD.ssd(*args)
        wy, wstate = SSD.ssd_plain(*args)
        torch.cuda.synchronize()
        rtol, atol = KERNEL_TOL["bfloat16"]
        err = max(_close(torch, y, wy, rtol, atol, f"ssd y {name}"),
                  _close(torch, state, wstate, 1e-4, 1e-4,
                         f"ssd state {name}"))
        if not (torch.equal(y, y2) and torch.equal(state, state2)):
            raise AssertionError(f"ssd {name}: two calls differ")
        simt = _simt_ssd(torch, SSD, build, *args)
        sy, sstate = simt()
        simt_err = max(_close(torch, sy, wy, rtol, atol, f"SIMT y {name}"),
                       _close(torch, sstate, wstate, 1e-4, 1e-4,
                              f"SIMT state {name}"))
        ms = _timed([("plain", lambda: SSD.ssd_plain(*args)),
                     ("kernel", lambda: SSD.ssd(*args)),
                     ("kernel2", lambda: SSD.ssd(*args)),
                     ("plain2", lambda: SSD.ssd_plain(*args)),
                     ("simt", simt)])
        dev = {"kernel": graph_ms(torch, lambda: SSD.ssd(*args)),
               "simt": graph_ms(torch, simt),
               "kernel2": graph_ms(torch, lambda: SSD.ssd(*args))}
        nbytes = (2 * 2 * x.numel() + 2 * 2 * Bm.numel() + 4 * dt.numel()
                  + 4 * A.numel() + 4 * state.numel())
        nops = _ssd_flops(B, T, H, P, N)
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = nops / BF16_OPS_PER_S * 1e3
        out[name] = dict(
            shape=f"B{B} T{T} H{H} P{P} N{N} bf16",
            max_abs_err=err, simt_max_abs_err=simt_err, bytes=nbytes,
            flops=nops, bound_ms=max(byte_ms, op_ms),
            bound_by="bytes" if byte_ms >= op_ms else "operations",
            ms=min(dev["kernel"], dev["kernel2"]), simt_ms=dev["simt"],
            events_ms=min(ms["kernel"], ms["kernel2"]),
            simt_events_ms=ms["simt"],
            plain_ms=min(ms["plain"], ms["plain2"]), runs=json.dumps(ms),
            device_runs=json.dumps(dev))
    return out


# the default init's decay, exp(-exp(0.18)) (w0 = 0.6 under the 0.18
# clamp): a served rwkv6-7b with random weights runs at exactly this decay
CLAMPED_W = 0.30203348
WKV_ELEMENT_OPS = 15   # per (t, p): log, 2 exp, 2 div, max x 2, muls, sums
WKV_CASES = [("serve_clamped", 4, 1024, 64, 64, "clamped"),  # B, T, H, P
             ("serve_real", 4, 1024, 64, 64, "real"),
             ("t100", 4, 100, 64, 64, "clamped"),
             ("t910", 4, 910, 64, 64, "clamped"),
             ("smoke_p16", 4, 1024, 4, 16, "real")]


def _wkv_flops(B, T, H, P, Lc):
    """The four chunk products' operations (att and att v over the strict
    lower triangle) plus the elementwise work, over T / Lc chunks."""
    tri = Lc * (Lc - 1) // 2
    per_chunk = 2 * (2 * Lc * P * P + 2 * tri * P)
    return B * H * (T // Lc) * per_chunk + WKV_ELEMENT_OPS * B * T * H * P


def earlier_wkv(torch, build):
    """The earlier ``wkv`` kernel (``tools/earlier/wkv.cu``: one block per
    (b, h) walking the chunks in order), built from its source, with the
    wrapper's arguments and outputs."""
    import ctypes

    fn = build.load("wkv", EARLIER).wkv_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(r, k, v, w, u, H, Lc):
        B, T, HP = r.shape
        y = torch.empty_like(r)
        state = torch.empty((B, H, HP // H, HP // H), device=r.device)
        dev, stream = build.device_and_stream(r)
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), y.data_ptr(), state.data_ptr(), B, T, H,
                 HP // H, Lc, dev, stream)
        if err:
            raise RuntimeError(f"earlier wkv launch failed: {err}")
        return y, state
    return run


def phase_wkv_kernel(torch, R, build, card):
    """``wkv`` (y and final state) against its plain version, through the
    model's ``wkv_chunked`` (JAX's chunk rule), at the serve phase's prefill
    shapes (B 4, T 1024, H 64, P 64) at the served decay and at real RWKV
    decays, at T 100 (one chunk of 100, subnormal A_excl) and T 910 (chunks
    of 65), and at the smoke width P 16; each timed beside the plain version
    and the earlier serial-chunk kernel on the same inputs (order plain,
    earlier, kernel, kernel, earlier, plain).  At real decays the kernel is
    also held against the naive recurrence (``wkv_decode`` step by step),
    as information: there the chunked form equals the recurrence."""
    g = torch.Generator(device=card).manual_seed(4)
    earlier = earlier_wkv(torch, build)
    out = {}
    for name, B, T, H, P, regime in WKV_CASES:
        shape = (B, T, H * P)
        r, k, v = (torch.randn(shape, generator=g, device=card)
                   for _ in range(3))
        w = (torch.full(shape, CLAMPED_W, device=card) if regime == "clamped"
             else torch.rand(shape, generator=g, device=card) * 0.149 + 0.85)
        u = torch.randn((H, P), generator=g, device=card) * 0.1
        args = (r, k, v, w, u, H)
        y, state = R.wkv_chunked(*args)
        wy, wstate = R.wkv_chunked(*args, use_kernel=False)
        torch.cuda.synchronize()
        nums = dict(max_abs_err_y=_close(torch, y, wy, 1e-4, 1e-4,
                                         f"wkv y {name}"),
                    max_abs_err_state=_close(torch, state, wstate, 1e-4,
                                             1e-4, f"wkv state {name}"),
                    max_abs_y=float(wy.abs().max()))
        if name == "serve_real":
            s = torch.zeros((B, H, P, P), device=card)
            ys = []
            for t in range(T):
                yt, s = R.wkv_decode(r[:, t:t + 1], k[:, t:t + 1],
                                     v[:, t:t + 1], w[:, t:t + 1], u, s)
                ys.append(yt)
            nums["vs_recurrence_max_abs_err_y"] = float(
                (torch.cat(ys, 1) - y).abs().max())
            nums["vs_recurrence_max_abs_err_state"] = float(
                (s - state).abs().max())
        Lc = R.chunk_len(T)
        ey, estate = earlier(*args, Lc)
        nums["earlier_max_abs_err_y"] = _close(torch, ey, wy, 1e-4, 1e-4,
                                               f"earlier wkv y {name}")
        ms = _timed([("plain", lambda: R.wkv_chunked(*args, use_kernel=False)),
                     ("earlier", lambda: earlier(*args, Lc)),
                     ("kernel", lambda: R.wkv_chunked(*args)),
                     ("kernel2", lambda: R.wkv_chunked(*args)),
                     ("earlier2", lambda: earlier(*args, Lc)),
                     ("plain2", lambda: R.wkv_chunked(*args,
                                                      use_kernel=False))])
        nbytes = 4 * (5 * r.numel() + u.numel() + state.numel())
        nops = _wkv_flops(B, T, H, P, Lc)
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = nops / FP32_OPS_PER_S * 1e3
        out[name] = dict(
            shape=f"B{B} T{T} H{H} P{P} chunk{Lc} float32 {regime}", **nums,
            bytes=nbytes, flops=nops, bound_ms=max(byte_ms, op_ms),
            bound_by="bytes" if byte_ms >= op_ms else "operations",
            ms=min(ms["kernel"], ms["kernel2"]),
            earlier_ms=min(ms["earlier"], ms["earlier2"]),
            plain_ms=min(ms["plain"], ms["plain2"]), runs=json.dumps(ms))
    return out


# Kernel path against plain path over a whole prefill of zamba2-1.2b.
# float32 (the algorithm): each kernel sums the same terms as its plain
# version in another order, and 38 layers carry float32 rounding on.
# bfloat16 (the served type): each kernel output is within a bf16 ulp of
# the plain one and 38 layers carry those ulps on as a random walk; the
# first card run measured single values of the O(1) logits and caches
# 0.14-0.19 apart with a mean error of 0.024 (~3 ulps) while the float32
# run of the same weights agreed far more closely, so the bf16 limits
# are about 1.3x those: 0.25 on any value, 0.04 on the mean.
PREFILL_TOL = {"float32": (2e-3, 2e-3, 2e-4),     # rtol, atol, mean
               "bfloat16": (5e-2, 2.5e-1, 4e-2)}


def _cache_leaves(cache):
    for i, layer in enumerate(cache.layers):
        for key, sub in layer.items():
            items = sub.items() if isinstance(sub, dict) else [(None, sub)]
            for k2, t in items:
                yield f"{i}/{key}" + (f"/{k2}" if k2 else ""), t


def kernel_vs_plain_prefill(torch, model, inputs, max_seq, dtype_name,
                            launches):
    """One prefill of ``inputs`` (the prefill's keyword inputs: tokens, or
    embeds and positions) with the kernels, one with ``use_kernels=False``:
    the greedy tokens, and every logit and cache value within PREFILL_TOL.
    In bfloat16 a row may pick another token only where the plain path's
    top two logits lie within the largest logit error (a near tie).  An
    MoE model's plain run takes the kernel run's routing (``PinnedRouting``);
    the tokens that would have been routed otherwise are reported."""
    from repro_torch.models.routing import PinnedRouting

    cfg = model.cfg
    pin = PinnedRouting()
    with pin:
        k_logits, k_cache = model.prefill(max_seq=max_seq, **inputs)
        pin.replay()
        model.cfg = dataclasses.replace(cfg, use_kernels=False)
        try:
            before = launches()
            p_logits, p_cache = model.prefill(max_seq=max_seq, **inputs)
            if launches() != before:
                raise AssertionError("use_kernels=False launched a kernel")
        finally:
            model.cfg = cfg
    rtol, atol, mean_tol = PREFILL_TOL[dtype_name]
    pairs = [("logits", k_logits, p_logits)] + [
        (path, t, dict(_cache_leaves(p_cache))[path])
        for path, t in _cache_leaves(k_cache)]
    worst, worst_err, mean_err = "", 0.0, 0.0
    for path, a, b in pairs:
        e = (a.float() - b.float()).abs()
        if float(e.max()) >= worst_err:
            worst, worst_err = path, float(e.max())
        mean_err = max(mean_err, float(e.mean()))
        if bool((e > atol + rtol * b.float().abs()).any()):
            raise AssertionError(f"{dtype_name} kernel vs plain prefill, "
                                 f"{path}: max abs err {float(e.max())}")
    if mean_err > mean_tol:
        raise AssertionError(f"{dtype_name} kernel vs plain prefill: mean "
                             f"abs err {mean_err}")
    logit_err = float((k_logits.float() - p_logits.float()).abs().max())
    top2 = p_logits.float().topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    differ = k_logits.argmax(-1) != p_logits.argmax(-1)
    if dtype_name == "float32" and bool(differ.any()):
        raise AssertionError(f"float32 greedy tokens differ: {differ}")
    if bool((differ & (margin > 2 * logit_err)).any()):
        raise AssertionError(f"greedy token differs past a near tie: "
                             f"margins {margin.tolist()}")
    if not bool(torch.isfinite(k_logits).all()):
        raise AssertionError("non-finite logits")
    moe = ({f"{dtype_name}_moe_tokens_routed_otherwise": pin.differ,
            f"{dtype_name}_moe_routed_tokens": pin.tokens}
           if cfg.num_experts else {})
    return {**moe, f"{dtype_name}_greedy_rows_equal": int((~differ).sum()),
            f"{dtype_name}_plain_top2_margins": json.dumps(
                [round(float(m), 5) for m in margin]),
            f"{dtype_name}_logits_max_abs_err": logit_err,
            f"{dtype_name}_worst_leaf": worst,
            f"{dtype_name}_worst_max_abs_err": worst_err,
            f"{dtype_name}_max_mean_abs_err": mean_err,
            f"{dtype_name}_cache_leaves": len(pairs) - 1}


def first_layers(cfg, n):
    """``cfg`` cut to its first ``n`` layers (their specs, in order)."""
    return dataclasses.replace(cfg, num_layers=n,
                               pattern=tuple(cfg.layer_specs()[:n]),
                               repeats=1, tail=())


def widened(torch, model, cfg, card):
    """A float32 model of ``cfg`` (``model``'s config, or its first layers)
    holding ``model``'s weights widened."""
    from repro_torch.models.model import Model

    wide = Model(dataclasses.replace(cfg, dtype=torch.float32), device=card)
    own = dict(model.named_parameters())
    with torch.no_grad():
        for name, a in wide.named_parameters():
            a.copy_(own[name])
    return wide


def phase_serve(torch, np, card, arch, kernels, per_prefill, lens, tag,
                check_len=None, requests=8, max_batch=4, new_tokens=16,
                layers=None, f32_layers=None):
    """Serve ``arch`` at full width (its first ``layers`` layers, or all);
    then the kernel path against the plain path on one cohort's prefill,
    in bf16 and on a float32 copy of the same weights (of the first
    ``f32_layers`` layers, or all), prefill + decode against the full
    forward (over the cohort's first ``check_len`` tokens, or all of them;
    an MoE at capacity factor E / k, so that the routing is per token), and
    a profile of one prefill and eight decode steps.

    ``kernels`` maps each kernel's name to its module (with ``launches``),
    ``per_prefill`` to its launches in one cohort's prefill; ``lens(rng,
    n)`` draws the prompt lengths.  Prints ``[serve_<tag>]`` lines."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, active_params
    from repro_torch.models.routing import PinnedRouting
    from repro_torch.serve import ServeEngine

    cfg = get_config(arch)
    if layers:
        cfg = first_layers(cfg, layers)
    held_before = torch.cuda.memory_allocated()   # by earlier phases
    t0 = time.perf_counter()
    model = Model(cfg, device=card).init_params(
        torch.Generator(device=card).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    lens = lens(rng, requests)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in lens]

    def launches():
        return sum(K.launches for K in kernels.values())

    tm = dict(prefill_s=0.0, decode_s=0.0, prefill_tokens=0,
              decode_tokens=0, decode_steps=0, decode_launches=0)
    cohorts = []
    prefill, decode_step = model.prefill, model.decode_step

    def timed_prefill(tokens, max_seq=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = prefill(tokens, max_seq)
        torch.cuda.synchronize()
        tm["prefill_s"] += time.perf_counter() - t
        tm["prefill_tokens"] += tokens.numel()
        cohorts.append((tokens, max_seq))
        return res

    def timed_decode(token, cache):
        before = launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = decode_step(token, cache)
        torch.cuda.synchronize()
        tm["decode_s"] += time.perf_counter() - t
        tm["decode_tokens"] += token.shape[0]
        tm["decode_steps"] += 1
        tm["decode_launches"] += launches() - before
        return res

    model.prefill, model.decode_step = timed_prefill, timed_decode
    eng = ServeEngine(model, max_batch=max_batch)
    for p in prompts:
        eng.submit(p, max_new_tokens=new_tokens)
    torch.cuda.reset_peak_memory_stats()
    for K in kernels.values():
        K.launches = 0
    t0 = time.perf_counter()
    stats = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: K.launches for name, K in kernels.items()}
    del model.prefill, model.decode_step
    nums = dict(
        params=sum(p.numel() for p in model.parameters()),
        active_params=active_params(cfg), layers=cfg.num_layers,
        init_s=init_s,
        requests=requests, finished=stats["finished"], cohorts=len(cohorts),
        prompt_lens=json.dumps([int(n) for n in lens]),
        padded_lens=json.dumps([int(t.shape[1]) for t, _ in cohorts]),
        wall_s=wall,
        avg_latency_s=stats["avg_latency"], p90_latency_s=stats["p90_latency"],
        avg_ttft_s=stats["avg_ttft"], runqlat_avg=stats["runqlat_avg"],
        prefill_s=tm["prefill_s"], prefill_tokens=tm["prefill_tokens"],
        prefill_tokens_per_s=tm["prefill_tokens"] / tm["prefill_s"],
        decode_s=tm["decode_s"], decode_steps=tm["decode_steps"],
        decode_tokens_per_s=tm["decode_tokens"] / tm["decode_s"],
        decode_ms_per_step=tm["decode_s"] * 1e3 / tm["decode_steps"],
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        held_by_earlier_phases=held_before,
        **{f"{name}_launches": n for name, n in counts.items()},
        decode_kernel_launches=tm["decode_launches"])
    say(f"serve_{tag}", **nums)
    if stats["finished"] != requests or any(
            len(r.tokens) != new_tokens for r in eng.finished):
        raise AssertionError("not every request got its tokens")
    if not all(0 <= t < cfg.vocab_size for r in eng.finished
               for t in r.tokens):
        raise AssertionError("a token outside the vocabulary")
    for name, n in counts.items():
        if n != per_prefill[name] * len(cohorts):
            raise AssertionError(
                f"{n} {name} launches for {len(cohorts)} cohorts "
                f"({per_prefill[name]} per prefill)")
    if tm["decode_launches"]:
        raise AssertionError(f"{tm['decode_launches']} kernel launches "
                             "while decoding")

    # one cohort's prefill, kernel path against plain path, in the served
    # bf16 and in float32 (the same weights widened)
    tokens, max_seq = cohorts[0]
    cons = dict(cohort=json.dumps(list(tokens.shape)))
    cons.update(kernel_vs_plain_prefill(torch, model, {"tokens": tokens},
                                        max_seq, "bfloat16", launches))
    wcfg = cfg if f32_layers is None else first_layers(cfg, f32_layers)
    wide = widened(torch, model, wcfg, card)
    # the float32 path: the 3xTF32 flash kernel's count set to 0 just
    # before the float32 copy's prefills and read just after (its plain
    # prefill launches nothing)
    FA = kernels.get("flash_attention")
    if FA is not None:
        FA.kernel_launches[FA.F32[0]] = 0
    cons.update(kernel_vs_plain_prefill(torch, wide, {"tokens": tokens},
                                        max_seq, "float32", launches))
    cons["float32_layers"] = wcfg.num_layers
    if FA is not None:
        n = nums["float32_flash_launches"] = FA.kernel_launches[FA.F32[0]]
        cons["float32_flash_launches"] = n
        want = (per_prefill["flash_attention"] if f32_layers is None
                else f32_layers)
        if n != want:
            raise AssertionError(f"{n} float32 flash launches in the "
                                 f"float32 prefill, {want} expected")
    del wide

    # prefill(x[:-1]) + decode(x[-1]) against the full forward (bf16), as
    # tests/test_archs_smoke.py holds the JAX models; the plain path beside
    x = tokens[:, :check_len] if check_len else tokens
    full_capacity = ({"capacity_factor": cfg.num_experts / cfg.experts_per_tok}
                     if cfg.num_experts else {})
    for path in ("kernel", "plain"):
        model.cfg = dataclasses.replace(cfg, use_kernels=path == "kernel",
                                        **full_capacity)
        try:
            # an MoE's prefill and decode take the forward's routing
            with PinnedRouting() as pin:
                full = model(x)[:, -1]
                pin.replay(lambda idx: idx[:, :-1])
                _, cache = model.prefill(x[:, :-1], x.shape[1])
                pin.replay(lambda idx: idx[:, -1:])
                dec, _ = model.decode_step(x[:, -1:], cache)
        finally:
            model.cfg = cfg
        cons[f"decode_vs_forward_{path}_max_abs_err"] = float(
            (dec.float() - full.float()).abs().max())
        if cfg.num_experts:
            cons[f"decode_vs_forward_{path}_moe_tokens_routed_otherwise"] = (
                pin.differ)
        if path == "kernel":
            close = torch.allclose(dec.float(), full.float(), rtol=0.1,
                                   atol=0.15)
    cons["decode_vs_forward_tokens"] = x.shape[1]
    say(f"serve_{tag}", **cons)
    if not close:
        raise AssertionError(
            "prefill + decode vs forward: kernel path "
            f"{cons['decode_vs_forward_kernel_max_abs_err']}, plain path "
            f"{cons['decode_vs_forward_plain_max_abs_err']}")

    # where the time goes: one cohort's prefill, then 8 decode steps
    say("serve_profile", model=arch, part="prefill", tokens=tokens.numel(),
        **device_profile(torch, lambda: model.prefill(tokens, max_seq), 1,
                         "prefill"))
    _, cache = model.prefill(tokens, tokens.shape[1] + 9)
    tok = tokens[:, -1:]
    model.decode_step(tok, cache)                  # warm the path

    def decode(steps=8):
        for _ in range(steps):
            model.decode_step(tok, cache)

    say("serve_profile", model=arch, part="decode",
        **device_profile(torch, decode, 8, "step"))
    return nums


# qwen2-vl-72b at full width on its first 10 of 80 layers (10.02 B of 71.46
# B parameters, ~20.0 GB of bf16 weights; the whole model is ~143 GB; 20
# layers until the MoE training phases came, to keep the script near 800
# s): two cohorts of 4 requests, each a 448 x 448 image (14-px patches
# merged 2 x 2: a 16 x 16 grid of 256 tokens) then text, 16 decode steps
# each
QWEN2VL_PARAMS = 71_459_676_160           # JAX's num_params of the config
QWEN2VL_LAYERS = 10
QWEN2VL_COHORTS = (1024, 512)             # S of each cohort
QWEN2VL_GRID = 16
QWEN2VL_BATCH, QWEN2VL_STEPS = 4, 16


def mrope_grid_positions(np, B, S, grid):
    """(3, B, S) M-RoPE positions of rows that each hold a ``grid`` x
    ``grid`` image (at t 0, h = row, w = col) and then text from ``grid``
    on, equal in the three streams."""
    n = grid * grid
    r, c = np.divmod(np.arange(n), grid)
    text = grid + np.arange(S - n)
    pos = np.stack([np.concatenate([np.zeros(n, np.int64), text]),
                    np.concatenate([r, text]), np.concatenate([c, text])])
    return np.broadcast_to(pos[:, None], (3, B, S)).copy()


def vlm_cohort(torch, np, card, B, S, D, grid, steps, seed):
    """One cohort's inputs from seeded numpy normals: (B, S, D) embeddings,
    each row a ``grid`` x ``grid`` image followed by text; their (3, B, S)
    M-RoPE positions (``mrope_grid_positions``); and ``steps`` (B, 1, D)
    decode embeddings."""
    rng = np.random.default_rng(seed)
    embeds = torch.from_numpy(rng.standard_normal(
        (B, S, D), dtype=np.float32)).to(card)
    positions = torch.from_numpy(mrope_grid_positions(np, B, S, grid)).to(
        card)
    dec = torch.from_numpy(rng.standard_normal(
        (steps, B, 1, D), dtype=np.float32)).to(card)
    return embeds, positions, dec


def phase_serve_qwen2vl(torch, np, card, FA):
    """qwen2-vl-72b at full width, its first ``QWEN2VL_LAYERS`` layers:
    each cohort's prefill at image-grid M-RoPE positions (one flash launch
    a layer: the bf16 wgmma kernel, hd 128, 64 query heads over 8 KV
    heads), then ``QWEN2VL_STEPS`` decode steps fed seeded embeddings (no
    launch), the greedy tokens reported, not fed back; the kernel path
    against the plain path on the first cohort's prefill in bf16 and on a
    float32 copy of the first 2 layers; prefill(x[:-1]) + decode(x[-1])
    against the forward at equal-stream positions (JAX's decode position
    is the forward's only there); profiles of one prefill and 8 decode
    steps.  The engine takes token prompts only, so the model is driven
    through its own entry points."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, num_params

    full_cfg = get_config("qwen2-vl-72b")
    if num_params(full_cfg) != QWEN2VL_PARAMS:
        raise AssertionError(f"qwen2-vl-72b: {num_params(full_cfg)} "
                             f"parameters, JAX counts {QWEN2VL_PARAMS}")
    cfg = first_layers(full_cfg, QWEN2VL_LAYERS)
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = Model(cfg, device=card).init_params(
        torch.Generator(device=card).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, steps = QWEN2VL_BATCH, QWEN2VL_STEPS
    cohorts = [vlm_cohort(torch, np, card, B, S, cfg.d_model, QWEN2VL_GRID,
                          steps, seed)
               for seed, S in enumerate(QWEN2VL_COHORTS)]
    tm = dict(prefill_s=0.0, decode_s=0.0, prefill_tokens=0)
    prefill_launches, decode_launches, greedy = [], 0, []
    torch.cuda.reset_peak_memory_stats()
    FA.launches = 0
    t0 = time.perf_counter()
    for embeds, positions, dec in cohorts:
        S = embeds.shape[1]
        torch.cuda.synchronize()
        t = time.perf_counter()
        before = FA.launches
        logits, cache = model.prefill(max_seq=S + steps, embeds=embeds,
                                      positions=positions)
        torch.cuda.synchronize()
        tm["prefill_s"] += time.perf_counter() - t
        tm["prefill_tokens"] += B * S
        prefill_launches.append(FA.launches - before)
        toks = [logits.argmax(-1)]
        before = FA.launches
        t = time.perf_counter()
        for i in range(steps):
            logits, cache = model.decode_step(embeds=dec[i], cache=cache)
            toks.append(logits.argmax(-1))
        torch.cuda.synchronize()
        tm["decode_s"] += time.perf_counter() - t
        decode_launches += FA.launches - before
        if cache.len != S + steps:
            raise AssertionError(f"cache length {cache.len}")
        greedy.append(torch.stack(toks, 1).tolist())
    wall = time.perf_counter() - t0
    launches = FA.launches
    n_steps = steps * len(cohorts)
    nums = dict(
        params=sum(p.numel() for p in model.parameters()),
        full_config_params=QWEN2VL_PARAMS, layers=cfg.num_layers,
        init_s=init_s, cohorts=len(cohorts), batch=B,
        cohort_lens=json.dumps(list(QWEN2VL_COHORTS)),
        image_tokens=QWEN2VL_GRID ** 2, wall_s=wall,
        prefill_s=tm["prefill_s"], prefill_tokens=tm["prefill_tokens"],
        prefill_tokens_per_s=tm["prefill_tokens"] / tm["prefill_s"],
        prefill_ms_per_cohort=tm["prefill_s"] * 1e3 / len(cohorts),
        decode_s=tm["decode_s"], decode_steps=n_steps,
        decode_ms_per_step=tm["decode_s"] * 1e3 / n_steps,
        decode_tokens_per_s=B * n_steps / tm["decode_s"],
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        held_by_earlier_phases=held_before,
        flash_attention_launches=launches,
        prefill_flash_launches=json.dumps(prefill_launches),
        decode_kernel_launches=decode_launches,
        greedy_tokens=json.dumps(greedy))
    say("serve_qwen2vl", **nums)
    if any(n != cfg.num_layers for n in prefill_launches):
        raise AssertionError(f"flash launches per prefill {prefill_launches}"
                             f", {cfg.num_layers} expected")
    if decode_launches:
        raise AssertionError(f"{decode_launches} kernel launches while "
                             "decoding")
    if not all(0 <= t < cfg.vocab_size for c in greedy for row in c
               for t in row):
        raise AssertionError("a token outside the vocabulary")

    def launched():
        return FA.launches

    # the first cohort's prefill, kernel path against plain path, in bf16
    # and on a float32 copy of the first 2 layers (the 3xTF32 kernel's count
    # set to 0 before and read after)
    embeds, positions, dec = cohorts[0]
    S = embeds.shape[1]
    inputs = {"embeds": embeds, "positions": positions}
    cons = dict(cohort=json.dumps([B, S]))
    cons.update(kernel_vs_plain_prefill(torch, model, inputs, S, "bfloat16",
                                        launched))
    wide = widened(torch, model, first_layers(cfg, 2), card)
    FA.kernel_launches[FA.F32[0]] = 0
    cons.update(kernel_vs_plain_prefill(torch, wide, inputs, S, "float32",
                                        launched))
    f32 = nums["float32_flash_launches"] = FA.kernel_launches[FA.F32[0]]
    cons["float32_layers"], cons["float32_flash_launches"] = 2, f32
    del wide
    if f32 != 2:
        raise AssertionError(f"{f32} float32 flash launches in the float32 "
                             "prefill, 2 expected")

    # prefill(x[:-1]) + decode(x[-1]) against the full forward at the
    # default, equal-stream positions (bf16), kernel and plain paths
    for path in ("kernel", "plain"):
        model.cfg = dataclasses.replace(cfg, use_kernels=path == "kernel")
        try:
            full = model(embeds=embeds)[:, -1]
            _, cache = model.prefill(max_seq=S, embeds=embeds[:, :-1])
            out, _ = model.decode_step(embeds=embeds[:, -1:], cache=cache)
        finally:
            model.cfg = cfg
        cons[f"decode_vs_forward_{path}_max_abs_err"] = float(
            (out.float() - full.float()).abs().max())
        if path == "kernel":
            close = torch.allclose(out.float(), full.float(), rtol=0.1,
                                   atol=0.15)
        del full
    cons["decode_vs_forward_tokens"] = S
    say("serve_qwen2vl", **cons)
    if not close:
        raise AssertionError(
            "prefill + decode vs forward: kernel path "
            f"{cons['decode_vs_forward_kernel_max_abs_err']}, plain path "
            f"{cons['decode_vs_forward_plain_max_abs_err']}")

    # where the time goes: one prefill, then 8 decode steps
    say("serve_profile", model="qwen2-vl-72b", part="prefill", tokens=B * S,
        **device_profile(torch, lambda: model.prefill(
            max_seq=S, embeds=embeds, positions=positions), 1, "prefill"))
    _, cache = model.prefill(max_seq=S + 9, embeds=embeds,
                             positions=positions)
    model.decode_step(embeds=dec[0], cache=cache)        # warm the path

    def decode(n=8):
        for i in range(n):
            model.decode_step(embeds=dec[i], cache=cache)

    say("serve_profile", model="qwen2-vl-72b", part="decode",
        **device_profile(torch, decode, 8, "step"))
    return nums


# hubert-xlarge at full width and depth (48 layers, 1.259 B parameters,
# ~2.5 GB of bf16 weights): B 8 x S 1,000 frame embeddings, 20 s of audio
# at HuBERT's 50 frames a second; forwards timed
HUBERT_PARAMS = 1_259_060_480             # JAX's num_params of the config
HUBERT_B, HUBERT_S, HUBERT_FORWARDS = 8, 1000, 5


def kernel_vs_plain_forward(torch, model, inputs, dtype_name, launched):
    """The full forward of ``inputs`` with the kernels and with
    ``use_kernels=False`` (which must launch nothing): every logit within
    PREFILL_TOL, and a frame's greedy unit differing only where the plain
    path's top two logits lie within twice the largest error."""
    cfg = model.cfg
    k_logits = model(**inputs)
    model.cfg = dataclasses.replace(cfg, use_kernels=False)
    try:
        before = launched()
        p_logits = model(**inputs)
        if launched() != before:
            raise AssertionError("use_kernels=False launched a kernel")
    finally:
        model.cfg = cfg
    rtol, atol, mean_tol = PREFILL_TOL[dtype_name]
    e = (k_logits.float() - p_logits.float()).abs()
    err, mean_err = float(e.max()), float(e.mean())
    if bool((e > atol + rtol * p_logits.float().abs()).any()):
        raise AssertionError(f"{dtype_name} kernel vs plain forward: max "
                             f"abs err {err}")
    if mean_err > mean_tol:
        raise AssertionError(f"{dtype_name} kernel vs plain forward: mean "
                             f"abs err {mean_err}")
    top2 = p_logits.float().topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    differ = k_logits.argmax(-1) != p_logits.argmax(-1)
    if bool((differ & (margin > 2 * err)).any()):
        raise AssertionError(f"{dtype_name}: a frame's unit differs past a "
                             "near tie")
    if not bool(torch.isfinite(k_logits).all()):
        raise AssertionError("non-finite logits")
    return {f"{dtype_name}_logits_max_abs_err": err,
            f"{dtype_name}_logits_mean_abs_err": mean_err,
            f"{dtype_name}_frames_differing": int(differ.sum()),
            f"{dtype_name}_frames": differ.numel()}


def phase_encode_hubert(torch, np, card, FA, build):
    """hubert-xlarge's encoder forward at full width and depth: the
    forwards timed (one non-causal flash launch a layer: the bf16 wgmma
    kernel at hd 80), the kernel path against the plain path in bf16 and
    on a float32 copy of the whole model (one 3xTF32 launch a layer),
    prefill's last logits against the forward's last row, a profile of one
    forward; then the non-causal flash case at its shape (B 8, S 1,000, H
    16, hd 80) in both dtypes beside SDPA and the plain version."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, num_params

    cfg = get_config("hubert-xlarge")
    if num_params(cfg) != HUBERT_PARAMS:
        raise AssertionError(f"hubert-xlarge: {num_params(cfg)} parameters,"
                             f" JAX counts {HUBERT_PARAMS}")
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = Model(cfg, device=card).init_params(
        torch.Generator(device=card).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    frames = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (HUBERT_B, HUBERT_S, cfg.d_model), dtype=np.float32)).to(card)
    logits = model(embeds=frames)                       # warm the path
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.launches = 0
    t0 = time.perf_counter()
    for _ in range(HUBERT_FORWARDS):
        logits = model(embeds=frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = FA.launches
    ms = wall * 1e3 / HUBERT_FORWARDS
    nums = dict(
        params=sum(p.numel() for p in model.parameters()),
        layers=cfg.num_layers, init_s=init_s,
        shape=json.dumps([HUBERT_B, HUBERT_S, cfg.d_model]),
        forwards=HUBERT_FORWARDS, wall_s=wall, ms_per_forward=ms,
        frames_per_s=HUBERT_B * HUBERT_S / (ms * 1e-3),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        held_by_earlier_phases=held_before,
        flash_attention_launches=launches)
    if launches != cfg.num_layers * HUBERT_FORWARDS:
        raise AssertionError(f"{launches} flash launches in "
                             f"{HUBERT_FORWARDS} forwards")
    if tuple(logits.shape) != (HUBERT_B, HUBERT_S, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"hubert logits {tuple(logits.shape)}")
    # every attention call of a forward is non-causal
    seen, real = [], FA.flash_attention

    def record(*a, **kw):
        seen.append(kw.get("causal", True))
        return real(*a, **kw)

    FA.flash_attention = record
    try:
        model(embeds=frames)
    finally:
        FA.flash_attention = real
    nums["non_causal_calls"] = seen.count(False)
    if seen != [False] * cfg.num_layers:
        raise AssertionError(f"attention calls' causal flags {seen}")
    say("encode_hubert", **nums)

    inputs = {"embeds": frames}
    cons = kernel_vs_plain_forward(torch, model, inputs, "bfloat16",
                                   lambda: FA.launches)
    last, _ = model.prefill(embeds=frames)
    err = float((last.float() - logits[:, -1].float()).abs().max())
    cons["prefill_last_vs_forward_max_abs_err"] = err
    if not torch.allclose(last.float(), logits[:, -1].float(), rtol=1e-2,
                          atol=1e-2):
        raise AssertionError(f"prefill's last logits vs forward: {err}")
    del logits, last
    wide = widened(torch, model, cfg, card)
    FA.kernel_launches[FA.F32[0]] = 0
    cons.update(kernel_vs_plain_forward(torch, wide, inputs, "float32",
                                        lambda: FA.launches))
    f32 = nums["float32_flash_launches"] = FA.kernel_launches[FA.F32[0]]
    cons["float32_flash_launches"] = f32
    del wide
    if f32 != cfg.num_layers:
        raise AssertionError(f"{f32} float32 flash launches in the float32 "
                             f"forward, {cfg.num_layers} expected")
    say("encode_hubert", **cons)
    prof = device_profile(torch, lambda: model(embeds=frames), 1, "forward")
    nums["device_busy_share"] = prof["device_busy_share"]
    nums["flash_device_share"] = prof["flash_device_share"]
    say("serve_profile", model="hubert-xlarge", part="forward",
        frames=HUBERT_B * HUBERT_S, **prof)
    del model, frames
    gc.collect()
    torch.cuda.empty_cache()

    # the non-causal kernel at hubert's attention shape
    g = torch.Generator(device=card).manual_seed(3)
    cases = {}
    for dt in ("bfloat16", "float32"):
        name = f"hubert_noncausal_{dt}"
        cases[name] = _flash_case(
            torch, FA, build, g, card, name, HUBERT_B, HUBERT_S,
            cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            getattr(torch, dt), 0, iters=100, causal=False)
        say("encode_hubert", case=name, **cases[name])
    return nums, cases


# --------------------------------------------------------------------------
# training: the backward flash kernel and smollm-135m at full size
# --------------------------------------------------------------------------

# dq, dk, dv of the kernel against the plain backward, within this share of
# each result's largest magnitude: float32 sums the same float32 products
# in another order over up to S keys (or S G queries); bf16 results are the
# same float32 values rounded, so a bf16 ulp (2^-8) of the largest at most
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# smollm-135m's train microbatch is B 4; the whole batch B 8 is the shape
# the bound and the SDPA backward are quoted at.  The last six are the
# attention of the last three families trained, at their microbatch:
# qwen3-moe 64 heads over 4 (GQA group 16, hd 64), dbrx 48 over 8 (group
# 6, hd 128), qwen2-vl 64 over 8 (group 8, hd 128); the SIMT kernel (on no
# route) is timed at the first seven only.
# name, B, S, H, KV, hd, dtype, window, causal, time the SIMT kernel
BWD_CASES = [("smollm", 8, 1024, 9, 3, 64, "bfloat16", 0, True, True),
             ("smollm_float32", 8, 1024, 9, 3, 64, "float32", 0, True, True),
             ("hubert", 8, 1000, 16, 16, 80, "bfloat16", 0, False, True),
             ("hubert_float32", 8, 1000, 16, 16, 80, "float32", 0, False,
              True),
             ("main_hd128", 4, 1024, 16, 16, 128, "bfloat16", 0, True, True),
             ("main_hd128_float32", 4, 1024, 16, 16, 128, "float32", 0, True,
              True),
             ("window_hd64", 1, 1000, 9, 3, 64, "bfloat16", 100, True, True),
             ("qwen3moe", 4, 1024, 64, 4, 64, "bfloat16", 0, True, False),
             ("qwen3moe_float32", 4, 1024, 64, 4, 64, "float32", 0, True,
              False),
             ("dbrx", 4, 1024, 48, 8, 128, "bfloat16", 0, True, False),
             ("dbrx_float32", 4, 1024, 48, 8, 128, "float32", 0, True, False),
             ("qwen2vl", 4, 1024, 64, 8, 128, "bfloat16", 0, True, False),
             ("qwen2vl_float32", 4, 1024, 64, 8, 128, "float32", 0, True,
              False)]


# the forward kernels' log-sum-exp against the plain version's: float32
# logs of the same float32 sums taken in another order, over scores whose
# own error (bf16 inputs' products in float32, or 3xTF32 at ~2^-21) is
# ~1e-6 of their size
LSE_TOL = dict(rtol=1e-5, atol=1e-4)


def _simt_bwd(torch, FA, build, q, k, v, out, do, causal, window):
    """The SIMT backward kernel (``csrc/flash_attention_bwd.cu``: its own m
    / l / D pre-pass, then dk / dv and dq) on q's dtype, called through its
    own entry: the port routes no pair to it since the wgmma and 3xTF32
    backward kernels replaced it, and this keeps its time beside theirs in
    the same run.  Returns a call that gives (dq, dk, dv)."""
    fn = getattr(build.load(FA.BWD_SIMT[0]), FA.BWD_SIMT[1])
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, S, H, hd = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    ws = torch.empty(3 * B * H * S, dtype=torch.float32, device=q.device)

    def run():   # on the current stream, which a graph capture sets
        dev, stream = build.device_and_stream(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 ws.data_ptr(), B, S, H, k.shape[2], hd, int(causal), window,
                 FA._DTYPES[q.dtype], dev, stream)
        if err:
            raise RuntimeError(f"SIMT flash bwd launch failed: {err}")
        return dq, dk, dv
    return run


def _profiled_device_ms(torch, fn, calls=5):
    """Device milliseconds per call of ``fn``: the kernels' own times in a
    ``torch.profiler`` trace of ``calls`` calls (for SDPA's backward,
    whose autograd call a CUDA graph does not capture as a whole).  In
    ``chip_smoke.py``, after its earlier phases' traces, this caught none
    or a fraction of the autograd engine's kernels (it read 0), where
    ``tools/train_phases.py``'s traces catch them all, so only that tool
    asks for it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               ) / calls / 1e3


def _bwd_errors(torch, name, got, want, tol):
    """Max abs error of dq, dk, dv and its share of each result's largest
    value, held to ``tol``."""
    nums = {}
    for part, a, b in zip(("dq", "dk", "dv"), got, want):
        err = float((a.float() - b.float()).abs().max())
        rel = err / max(float(b.float().abs().max()), 1e-30)
        nums[f"max_abs_err_{part}"] = err
        nums[f"rel_err_{part}"] = rel
        if rel > tol:
            raise AssertionError(f"flash bwd {name} {part}: {rel} of the "
                                 f"largest value, past {tol}")
    return nums


def _bwd_case(torch, FA, build, g, card, name, B, S, H, KV, hd, dtype,
              window, causal, simt_timed=True, library_device=False):
    """The backward kernel (bf16 the wgmma one, float32 the 3xTF32 one)
    against ``flash_attention_bwd_plain`` on the same q, k, v, out and lse
    (the forward kernel's) and dO: max abs error of dq, dk, dv and their
    share of each result's largest value, two launches compared bit for
    bit; the forward kernel's lse against the plain version's and its out
    bit-equal with and without lse; with ``simt_timed`` the SIMT kernel it
    replaced on the same inputs; times by CUDA events (order plain, kernel,
    kernel, plain, library: ``scaled_dot_product_attention``'s backward on
    the same tensors, timed only; then the SIMT kernel) and the kernel's
    and the SIMT kernel's device times from CUDA graphs, SDPA's backward's
    from a profiler trace with ``library_device`` (``library_device_ms``,
    else None); the bound is the largest of the inputs and outputs over the
    memory rate, the backward's five products over the kept pairs (s
    recomputed, dp, dv, dk, dq; 2 hd flops each) at the bf16 tensor cores'
    rate (float32 at 3xTF32's, as the forward's bound), and one exponential
    a kept pair."""
    import torch.nn.functional as F

    q, k, v, do = (torch.randn((B, S, h, hd), generator=g, device=card,
                               dtype=torch.float32).to(dtype)
                   for h in (H, KV, KV, H))
    kw = dict(causal=causal, sliding_window=window)
    out, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
    bare = FA.flash_attention(q, k, v, **kw)
    _, plain_lse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, bare):
        raise AssertionError(f"flash bwd {name}: the forward's out differs "
                             "with lse written")
    lse_err = _close(torch, lse, plain_lse, what=f"flash lse {name}",
                     **LSE_TOL)
    del bare, plain_lse
    kernel = FA.bwd_route(dtype, hd)[0]
    before = FA.bwd_kernel_launches[kernel]
    got = FA.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    again = FA.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    want = FA.flash_attention_bwd_plain(q, k, v, out, do, **kw)
    simt = (_simt_bwd(torch, FA, build, q, k, v, out, do, causal, window)
            if simt_timed else None)
    simt_got = simt() if simt else None
    torch.cuda.synchronize()
    if FA.bwd_kernel_launches[kernel] != before + 2 * FA.BWD_LAUNCHES_PER_CALL:
        raise AssertionError(f"flash bwd {name}: not routed to {kernel}")
    tol = BWD_TOL[str(dtype).split(".")[-1]]
    nums = _bwd_errors(torch, name, got, want, tol)
    for part, a, c in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(a, c):
            raise AssertionError(f"flash bwd {name} {part}: two launches "
                                 "differ")
    simt_nums = (_bwd_errors(torch, f"{name} SIMT", simt_got, want, tol)
                 if simt else None)
    del got, again, want, simt_got
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    i = torch.arange(S, device=card)
    keep = ((i[:, None] >= i[None, :]) | (not causal)) & (
        i[None, :] > i[:, None] - window - 1 if window else True)
    sdpa = dict(is_causal=causal) if not window else dict(attn_mask=keep)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=KV != H,
                                             **sdpa)
    dot = do.transpose(1, 2)
    fns = [
        ("plain", lambda: FA.flash_attention_bwd_plain(q, k, v, out, do,
                                                       **kw)),
        ("kernel", lambda: FA.flash_attention_bwd(q, k, v, out, do, lse,
                                                  **kw)),
        ("kernel2", lambda: FA.flash_attention_bwd(q, k, v, out, do, lse,
                                                   **kw)),
        ("plain2", lambda: FA.flash_attention_bwd_plain(q, k, v, out, do,
                                                        **kw)),
        ("library", lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True))] + (
        [("simt", simt)] if simt else [])
    ms = {n: cuda_ms(fn, iters=10 if n in ("plain", "plain2", "simt")
                     else 30, warmup=2) for n, fn in fns}
    device_ms = graph_ms(torch, fns[1][1], calls=3, replays=5)
    simt_device_ms = graph_ms(torch, simt, calls=2, replays=3) if simt \
        else None
    library_device_ms = _profiled_device_ms(torch, fns[4][1]) \
        if library_device else None
    pairs = int(keep.sum())
    # q, out, dO, k, v read; dq, dk, dv written
    nbytes = q.element_size() * 4 * (q.numel() + k.numel())
    nops = 5 * 2 * hd * B * H * pairs
    f32 = dtype == torch.float32
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "products": nops / (F32_3XTF32_OPS_PER_S if f32
                                 else BF16_OPS_PER_S) * 1e3,
             "exponentials": B * H * pairs / ex2_per_s(torch) * 1e3}
    term = max(terms, key=terms.get)
    return dict(
        shape=f"B{B} S{S} H{H}/{KV} hd{hd} {dtype} window{window}"
              + ("" if causal else " non-causal"),
        kernel=kernel, **nums, lse_max_abs_err=lse_err,
        simt_max_rel_err=max(simt_nums[f"rel_err_{p}"]
                             for p in ("dq", "dk", "dv")) if simt else None,
        bytes=nbytes, flops=nops, bound_ms=terms[term],
        bound_by="bytes" if term == "bytes" else "operations",
        bound_term=term, bound_terms_ms=json.dumps(terms),
        cuda_core_bound_ms=max(terms["bytes"], nops / FP32_OPS_PER_S * 1e3),
        ms=min(ms["kernel"], ms["kernel2"]), device_ms=device_ms,
        plain_ms=min(ms["plain"], ms["plain2"]), library_ms=ms["library"],
        library_device_ms=library_device_ms, simt_ms=ms.get("simt"),
        simt_device_ms=simt_device_ms, runs=json.dumps(ms))


def phase_flash_bwd_kernel(torch, FA, build, card, library_device=False,
                           cases=None):
    """The backward kernels (bf16 ``csrc/flash_attention_bwd_sm90.cu``,
    float32 ``csrc/flash_attention_bwd_f32_sm90.cu``) against their plain
    version at smollm-135m's train shape, hubert-xlarge's (non-causal, hd
    80), ``main_hd128`` and the attention of qwen3-moe, dbrx and qwen2-vl
    (GQA groups 16, 6 and 8), each in bf16 and float32, and a windowed
    case at hd 64: errors, determinism, the forward's lse, times beside
    SDPA's backward and (the first seven cases) the SIMT kernel they
    replaced, bounds (SDPA's backward's device time only with
    ``library_device``: see ``_profiled_device_ms``).  ``cases`` (names of
    ``BWD_CASES``) runs those alone; the inputs come from one generator in
    the cases' order."""
    g = torch.Generator(device=card).manual_seed(7)
    out = {}
    for name, B, S, H, KV, hd, dt, window, causal, simt in BWD_CASES:
        if cases is not None and name not in cases:
            continue
        out[name] = _bwd_case(torch, FA, build, g, card, name, B, S, H, KV,
                              hd, getattr(torch, dt), window, causal, simt,
                              library_device)
        gc.collect()
        torch.cuda.empty_cache()
    return out


TRAIN_STEPS = 20
TRAIN_B, TRAIN_S, TRAIN_ACCUM = 8, 1024, 2
# the float32 copy's gradients, each leaf's max abs error over its largest
# magnitude.  The backward kernel against the plain backward on the same
# forward values (the plain forward's, or the 3xTF32 kernel's) holds 1e-4:
# float32 sums in another order.  The whole kernel path against the plain
# path differs by more: the 3xTF32 forward rounds its outputs at ~2^-21,
# and the wq / wk gradients of a trained model amplify that ~100-1,000
# times (3.8e-4 and 1.1e-3 in two runs, 7e-5 at the init; the same with
# the plain backward on the kernel forward), so that comparison is held
# to 1e-2, a bound on gross faults, not on rounding.
TRAIN_GRAD_TOL = 1e-4
TRAIN_PATH_TOL = 1e-2


def phase_train_smollm(torch, card, FA):
    """smollm-135m at full size (30 layers, d 576, vocab 49,152, random
    weights seeded 0) trained by the launcher's ``train_loop`` for 20
    steps on ``SyntheticLM(seq 1,024, global batch 8, seed 0)``: remat,
    accum 2, int8 compression, lr 6e-4 with the launcher's warmup; both
    flash counts set to 0 before and read after (2 forward launches a
    layer a microbatch under remat, one backward call's 3 launches a layer
    a microbatch); the loss must fall (mean of the last five steps below
    the first five's) and stay finite; step ms, tokens/s, peak memory,
    one more step profiled; then, on one batch, a float32 copy of the
    model's gradients through the kernels against the plain path's, and
    through each kernel alone (the other direction plain)."""
    from repro_torch.configs import get_config
    from repro_torch.train.train_step import batch_to_device

    cfg = get_config("smollm-135m")
    per_step = cfg.num_layers * TRAIN_ACCUM * TRAIN_STEPS
    want_fwd = per_step * 2
    want_bwd = per_step * FA.BWD_LAUNCHES_PER_CALL
    model, opt, nums = train_and_check(
        torch, card, "train_smollm", cfg, TRAIN_STEPS, flash_counters(FA), dict(flash_attention=want_fwd,
                                 flash_bwd=want_bwd, flash_sm90=want_fwd,
                                 flash_bwd_sm90=want_bwd))

    # one more step under the profiler
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step

    step_fn = make_train_step(model, AdamWConfig(lr=6e-4), accum=TRAIN_ACCUM,
                              remat=True, compress=True,
                              schedule_kwargs={"warmup": 10,
                                               "total": TRAIN_STEPS})
    batch = launcher_batch(cfg, TRAIN_STEPS)
    prof_nums, opt = profiled_step(
        torch, step_fn, opt, batch, {"flash_bwd": ("bwd_",),
                                     "flash_fwd": ("flash_sm90",)})
    nums.update(prof_nums)
    say("train_smollm", part="profile", **prof_nums)
    del opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    # a float32 copy, on one batch: the kernel path's gradients against the
    # plain path's, and each kernel alone under the other's plain version
    wide = widened(torch, model, cfg, card)
    del model
    cons = flash_swapped_grads(torch, FA, wide, batch_to_device(batch, card))
    say("train_smollm", part="float32_grads", **cons)
    check_flash_swapped(cons, "train_smollm", cfg.num_layers, FA)
    nums.update(cons)
    del wide
    gc.collect()
    torch.cuda.empty_cache()
    return nums


def flash_counters(FA):
    """The flash kernels' launch counters by name, each a (holder, key):
    every launch of the forward and the backward, and those on the bf16
    wgmma libraries."""
    return {"flash_attention": (FA, "launches"),
            "flash_bwd": (FA, "bwd_launches"),
            "flash_sm90": (FA.kernel_launches, FA.SM90[0]),
            "flash_bwd_sm90": (FA.bwd_kernel_launches, FA.BWD_SM90[0])}


def _count(holder, key, value=None):
    """Read a launch counter (a module's attribute or a dict's entry), or
    set it to ``value``."""
    if value is None:
        return holder[key] if isinstance(holder, dict) else getattr(holder,
                                                                    key)
    if isinstance(holder, dict):
        holder[key] = value
    else:
        setattr(holder, key, value)


def train_and_check(torch, card, tag, cfg, steps, counters, want):
    """``cfg`` (random weights seeded 0) trained by the launcher's
    ``train_loop`` for ``steps`` steps on ``SyntheticLM(seq 1,024, global
    batch 8, seed 0)``: remat, accum 2, int8 compression, lr 6e-4 with the launcher's warmup.  Each of ``counters`` (name -> a
    (holder, key) launch counter) is set to 0 before and read after, and
    held to ``want``; the loss must stay finite and fall (the mean of the
    last five steps below the first five's).  Prints ``[tag]`` with step ms
    (the median of steps 2 on), tokens/s, peak memory (under 90% of the
    card) and the memory earlier phases hold.  Returns (model, opt state,
    numbers)."""
    from repro_torch.launch.train import train_loop

    held_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for holder, key in counters.values():
        _count(holder, key, 0)
    history = []
    t0 = time.perf_counter()
    model, opt, losses = train_loop(
        cfg, steps=steps, global_batch=TRAIN_B, seq_len=TRAIN_S,
        accum=TRAIN_ACCUM, compress=True, lr=6e-4, seed=0, device=card,
        history=history, log_every=5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: _count(*c) for k, c in counters.items()}
    if got != want:
        raise AssertionError(f"{tag} launches {got}, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: a train loss is not finite: {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not last < first:
        raise AssertionError(f"{tag}: loss did not fall: {first} -> {last}")
    peak = torch.cuda.max_memory_allocated()
    card_bytes = torch.cuda.get_device_properties(card).total_memory
    if peak >= 0.9 * card_bytes:
        raise AssertionError(f"{tag}: peak memory {peak} of {card_bytes}")
    step_ms = sorted(h["ms"] for h in history[1:])
    median = step_ms[len(step_ms) // 2]
    nums = dict(
        params=sum(p.numel() for p in model.parameters()),
        layers=cfg.num_layers, d_model=cfg.d_model, steps=steps,
        batch=json.dumps([TRAIN_B, TRAIN_S]), accum=TRAIN_ACCUM,
        wall_s=wall, first_step_ms=history[0]["ms"],
        median_step_ms=median, min_step_ms=step_ms[0],
        tokens_per_s=TRAIN_B * TRAIN_S / (median * 1e-3),
        loss_first5=first, loss_last5=last,
        losses=json.dumps(losses),   # unrounded: two trees' bits compare
        grad_norms=json.dumps([round(h["grad_norm"], 4) for h in history]),
        max_memory_allocated=peak, card_memory=card_bytes,
        peak_share_of_card=peak / card_bytes,
        held_by_earlier_phases=held_before,
        **{f"{k}_launches": v for k, v in got.items()})
    say(tag, **nums)
    return model, opt, nums


def launcher_batch(cfg, step):
    """Batch ``step`` of the training data ``train_loop`` draws for ``cfg``
    at TRAIN_S x TRAIN_B (embeddings and M-RoPE positions for qwen2-vl, as
    the launcher asks)."""
    from repro_torch.data import SyntheticLM

    return SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0,
                       embed_dim=cfg.d_model if cfg.embed_inputs else 0,
                       mrope=bool(cfg.mrope_sections)).batch(step)


def first_rows(batch, n):
    """The first ``n`` rows of a batch (positions (3, B, S) along B)."""
    return {k: v[:, :n] if k == "positions" else v[:n]
            for k, v in batch.items()}


def profiled_step(torch, step_fn, opt, batch, shares):
    """One train step under ``torch.profiler``: host ms, device time, the
    device's busy share, kernels, the top eight, and for each of ``shares``
    (name -> substrings) the share of device time of the kernels whose
    names hold one.  Returns (numbers, the new optimizer state)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt, _ = step_fn(opt, batch)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in rows)

    def share(keys):
        us = sum(e.self_device_time_total for e in rows
                 if any(k in e.key for k in keys))
        return us / device_us if device_us else 0.0

    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
    return dict(
        profiled_step_ms=prof_s * 1e3, device_us=device_us,
        device_busy_share=device_us * 1e-6 / prof_s,
        kernels=sum(e.count for e in rows),
        **{f"{k}_device_share": share(v) for k, v in shares.items()},
        top=json.dumps([[e.key[:48], e.self_device_time_total, e.count]
                        for e in top])), opt


def flash_swapped_grads(torch, FA, wide, batch, pin=None):
    """A float32 model's gradients on ``batch`` with the flash directions
    swapped, in the order: both kernels, the forward kernel with the plain
    backward on its out and lse, both plain versions, the plain forward
    with the backward kernel (at most three sets of gradients held).  The
    worst leaf, each leaf's max abs error over its largest value: the whole
    kernel path against the plain path, the backward kernel alone and on
    the kernel forward, the forward kernel alone; the kernel run's 3xTF32
    forward and backward launches.  With ``pin`` (a ``PinnedRouting``,
    entered) the first run records the MoE's routing and every later run
    takes it; the tokens it moved are reported."""
    from repro_torch.models import model as TM

    wide.requires_grad_(True)
    params = list(wide.parameters())
    names = [n for n, _ in wide.named_parameters()]
    real = FA.FlashAttention

    class Mixed(torch.autograd.Function):
        """One direction through its kernel, the other through the plain
        version: ``fwd_kernel`` says which."""
        fwd_kernel = True

        @staticmethod
        def forward(ctx, q, k, v, causal, window):
            fn = FA.flash_attention if Mixed.fwd_kernel else \
                FA.flash_attention_plain
            out, lse = fn(q, k, v, causal=causal, sliding_window=window,
                          return_lse=True)
            ctx.save_for_backward(q, k, v, out.contiguous(), lse)
            ctx.mask = (causal, window)
            return out

        @staticmethod
        def backward(ctx, do):
            fn = FA.flash_attention_bwd_plain if Mixed.fwd_kernel else \
                FA.flash_attention_bwd
            q, k, v, out, lse = ctx.saved_tensors
            return (*fn(q, k, v, out, do.contiguous(), lse,
                        causal=ctx.mask[0], sliding_window=ctx.mask[1]),
                    None, None)

    def grads_of(how):
        wide.cfg = dataclasses.replace(wide.cfg, use_kernels=how != "plain")
        Mixed.fwd_kernel = how == "fwd_kernel"
        FA.FlashAttention = Mixed if how.endswith("kernel") else real
        try:
            loss, _ = TM.train_loss(wide, batch, remat=True)
            grads = torch.autograd.grad(loss, params)
        finally:
            FA.FlashAttention = real
        if pin is not None:
            pin.replay()
        for n, g in zip(names, grads):
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"float32 gradient {n} ({how}) is not "
                                     "finite")
        return float(loss.detach()), grads

    def worst(a_grads, b_grads):
        out = (0.0, None)
        for n, a, b in zip(names, a_grads, b_grads):
            rel = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
            if rel >= out[0]:
                out = (rel, n)
        return out

    FA.kernel_launches[FA.F32[0]], FA.bwd_launches = 0, 0
    FA.bwd_kernel_launches[FA.BWD_F32[0]] = 0
    loss_k, g_kernel = grads_of("kernels")
    f32_fwd, f32_bwd = FA.kernel_launches[FA.F32[0]], FA.bwd_launches
    if FA.bwd_kernel_launches[FA.BWD_F32[0]] != f32_bwd:
        raise AssertionError("float32 copy's backward not on the 3xTF32 "
                             "kernel")
    _, g_fwd_kernel = grads_of("fwd_kernel")    # 3xTF32 forward only
    bwd_on_kernel_fwd, bwd_fwd_leaf = worst(g_kernel, g_fwd_kernel)
    loss_p, g_plain = grads_of("plain")
    fwd_alone, _ = worst(g_fwd_kernel, g_plain)
    del g_fwd_kernel
    path, path_leaf = worst(g_kernel, g_plain)
    del g_kernel
    _, g_bwd_kernel = grads_of("bwd_kernel")    # backward kernel only
    bwd_alone, bwd_leaf = worst(g_bwd_kernel, g_plain)
    del g_plain, g_bwd_kernel
    moe = ({} if pin is None else
           {"moe_tokens_routed_otherwise": pin.differ,
            "moe_routed_tokens": pin.tokens})
    return dict(float32_loss_kernel=loss_k, float32_loss_plain=loss_p,
                float32_grad_worst_rel_err=path,
                float32_grad_worst_leaf=path_leaf,
                bwd_kernel_alone_worst_rel_err=bwd_alone,
                bwd_kernel_alone_worst_leaf=bwd_leaf,
                bwd_kernel_on_kernel_forward_worst_rel_err=bwd_on_kernel_fwd,
                bwd_kernel_on_kernel_forward_worst_leaf=bwd_fwd_leaf,
                fwd_kernel_alone_worst_rel_err=fwd_alone,
                float32_flash_launches=f32_fwd,
                float32_flash_bwd_launches=f32_bwd, **moe)


def check_flash_swapped(cons, tag, layers, FA):
    """``flash_swapped_grads``'s numbers held: the backward kernel within
    TRAIN_GRAD_TOL of each leaf's largest value against the plain backward,
    on the plain forward's values and on the kernel forward's; the whole
    kernel path within TRAIN_PATH_TOL; one 3xTF32 forward launch a layer
    and its recompute, one backward call a layer."""
    for what, err, leaf in (
            ("alone", cons["bwd_kernel_alone_worst_rel_err"],
             cons["bwd_kernel_alone_worst_leaf"]),
            ("on the kernel forward",
             cons["bwd_kernel_on_kernel_forward_worst_rel_err"],
             cons["bwd_kernel_on_kernel_forward_worst_leaf"])):
        if not err <= TRAIN_GRAD_TOL:
            raise AssertionError(f"{tag} float32 gradients, backward kernel "
                                 f"{what}: {err} at {leaf}, past "
                                 f"{TRAIN_GRAD_TOL}")
    if not cons["float32_grad_worst_rel_err"] <= TRAIN_PATH_TOL:
        raise AssertionError(
            f"{tag} float32 gradients, kernel path vs plain: "
            f"{cons['float32_grad_worst_rel_err']} at "
            f"{cons['float32_grad_worst_leaf']}, past {TRAIN_PATH_TOL}")
    want = (2 * layers, FA.BWD_LAUNCHES_PER_CALL * layers)
    got = (cons["float32_flash_launches"], cons["float32_flash_bwd_launches"])
    if got != want:
        raise AssertionError(f"{tag} float32 copy launches {got}, {want} "
                             "expected")


# --------------------------------------------------------------------------
# training the scan families: the SSD and WKV backward kernels, then
# zamba2-1.2b at full size and rwkv6-7b at full width
# --------------------------------------------------------------------------

SCAN_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC")
WKV_GRADS = ("dr", "dk", "dv", "dw", "du")
# B, T, H, P, N, dtype, final-state gradient: zamba2-1.2b's train
# microbatch in both types, a ragged T, the smoke width (P = N = 16, 8
# heads)
SSD_BWD_CASES = [("train", 4, 1024, 64, 64, 64, "bfloat16", False),
                 ("train_float32", 4, 1024, 64, 64, 64, "float32", False),
                 ("ragged", 4, 1000, 64, 64, 64, "bfloat16", True),
                 ("smoke", 4, 200, 8, 16, 16, "bfloat16", True)]
# B, T, H, P, decay, final-state gradient: rwkv6-7b's train microbatch at
# the default init's decay (the floors bind) and at real decays, the smoke
# width (P 16, 4 heads), and rwkv6-7b's width at T 160, where JAX's rule
# gives two chunks of 80 steps (the kernel's two 64-row halves)
WKV_BWD_CASES = [("train_clamped", 4, 1024, 64, 64, "clamped", False),
                 ("train_real", 4, 1024, 64, 64, "real", True),
                 ("smoke", 4, 1024, 4, 16, "real", True),
                 ("long_chunks_clamped", 4, 160, 64, 64, "clamped", False),
                 ("long_chunks_real", 4, 160, 64, 64, "real", True)]


def _ssd_bwd_flops(B, T, H, P, N, L=64):
    """The backward's least products over whole chunks of L steps: per
    (b, chunk, h) the five P x N x L ones (the chunk's state and dS0
    shares, dS1 B, dy S0, x dS1; the inter-chunk term of dt's gradient,
    C_t . exp(cum_t) S0^T dy_t, reuses dy S0) and, over the lower
    triangle, dy x^T, W^T dy, R B and R^T C; C B^T once per (b, chunk), as
    no head changes it.  The elementwise work (O(L P) a block beside these
    O(L P N)) is not counted."""
    tri = L * (L + 1) // 2
    nc = -(-T // L)
    per_head = 2 * (5 * L * P * N + tri * (2 * P + 2 * N))
    return B * nc * (H * per_head + 2 * tri * N)


def _wkv_bwd_flops(B, T, H, P, Lc):
    """The backward's least products over T / Lc chunks: per (b, chunk,
    h) the five P x P x Lc ones (the chunk's state and dS0 shares, dy
    S0^T, v dS1^T, kw dS1) and, over the strict lower triangle, att, datt,
    datt kd, datt^T qd and att^T dy.  The elementwise work (the decays,
    dr, dk, dw: O(Lc P) a block beside these O(Lc P^2)) is not counted."""
    tri = Lc * (Lc - 1) // 2
    per_chunk = 2 * (5 * Lc * P * P + 5 * tri * P)
    return B * H * (T // Lc) * per_chunk


def _scan_bwd_case(torch, lib, name, args, dy, ds, bwd, bwd_plain, grads,
                   dtype, nbytes, nops, ops_per_s):
    """A backward kernel against its plain version on the same inputs:
    each gradient's max abs error and its share of the largest value (held
    to SCAN_BWD_TOL), launches per call, two calls bit for bit; times by
    CUDA events (plain, kernel, kernel, plain) and the kernel's device time
    from CUDA graphs; the bound, the larger of the bytes over the memory
    rate and the least products over ``ops_per_s``, and beside it the bound
    with the products on the float32 CUDA cores."""
    before = lib.bwd_launches
    got = bwd(*args, dy, ds)
    again = bwd(*args, dy, ds)
    torch.cuda.synchronize()
    per_call = (lib.bwd_launches - before) // 2
    if per_call != lib.BWD_LAUNCHES_PER_CALL:
        raise AssertionError(f"{name}: {per_call} launches a call")
    want = bwd_plain(*args, dy, ds)
    tol = SCAN_BWD_TOL[dtype]
    nums = {}
    for part, a, b, c in zip(grads, got, want, again):
        if not torch.equal(a, c):
            raise AssertionError(f"{name} {part}: two calls differ")
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name} {part}: not finite")
        err = float((a.float() - b.float()).abs().max())
        rel = err / max(float(b.float().abs().max()), 1e-30)
        nums[f"max_abs_err_{part}"] = err
        nums[f"rel_err_{part}"] = rel
        if rel > tol:
            raise AssertionError(f"{name} {part}: {rel} of the largest "
                                 f"value, past {tol}")
    del got, again, want
    fns = [("plain", lambda: bwd_plain(*args, dy, ds)),
           ("kernel", lambda: bwd(*args, dy, ds)),
           ("kernel2", lambda: bwd(*args, dy, ds)),
           ("plain2", lambda: bwd_plain(*args, dy, ds))]
    ms = {n: cuda_ms(fn, iters=3 if n.startswith("plain") else 10, warmup=1)
          for n, fn in fns}
    device_ms = graph_ms(torch, fns[1][1], calls=3, replays=3)
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = nops / ops_per_s * 1e3
    return dict(
        launches_per_call=per_call, deterministic=True, **nums,
        max_abs_err=max(nums[f"max_abs_err_{p}"] for p in grads),
        max_rel_err=max(nums[f"rel_err_{p}"] for p in grads),
        bytes=nbytes, flops=nops, bound_ms=max(byte_ms, op_ms),
        bound_by="bytes" if byte_ms >= op_ms else "operations",
        bound_terms_ms=json.dumps({"bytes": byte_ms, "products": op_ms}),
        cuda_core_bound_ms=max(byte_ms, nops / FP32_OPS_PER_S * 1e3),
        ms=device_ms, events_ms=min(ms["kernel"], ms["kernel2"]),
        plain_ms=min(ms["plain"], ms["plain2"]), library_ms=None,
        runs=json.dumps(ms))


def phase_ssd_bwd_kernel(torch, SSD, card):
    """``ssd_bwd`` (``csrc/ssd_bwd_sm90.cu``) against ``ssd_bwd_plain`` at
    zamba2-1.2b's train microbatch in bf16 and float32, a ragged T and the
    smoke width, with and without a final-state gradient; A = -linspace(1,
    16, H) as the model's init, where JAX's own gradient is NaN.  The bound
    takes the products at the bf16 tensor cores' rate for bf16 inputs and
    at 3xTF32's for float32 ones (float32 accuracy on the tensor cores, as
    the float32 flash bounds take it)."""
    g = torch.Generator(device=card).manual_seed(11)
    out = {}
    for name, B, T, H, P, N, dt_name, with_state in SSD_BWD_CASES:
        dtype = getattr(torch, dt_name)
        x = torch.randn((B, T, H, P), generator=g, device=card).to(dtype)
        dt = torch.rand((B, T, H), generator=g, device=card) * 0.19 + 0.01
        A = -torch.linspace(1.0, 16.0, H, device=card)
        Bm, Cm = (torch.randn((B, T, N), generator=g, device=card).to(dtype)
                  for _ in range(2))
        dy = torch.randn((B, T, H, P), generator=g, device=card).to(dtype)
        ds = (torch.randn((B, H, P, N), generator=g, device=card)
              if with_state else None)
        es = x.element_size()
        # x, dy and dx; B, C, dB, dC; dt and ddt; A, dA; the state gradient
        nbytes = (3 * es * x.numel() + 4 * es * Bm.numel()
                  + 2 * 4 * dt.numel() + 2 * 4 * H
                  + (4 * ds.numel() if with_state else 0))
        out[name] = dict(
            shape=f"B{B} T{T} H{H} P{P} N{N} {dt_name}"
                  + (" dstate" if with_state else ""),
            **_scan_bwd_case(
                torch, SSD, f"ssd_bwd {name}", (x, dt, A, Bm, Cm), dy, ds,
                SSD.ssd_bwd, SSD.ssd_bwd_plain, SSD_GRADS, dt_name, nbytes,
                _ssd_bwd_flops(B, T, H, P, N),
                BF16_OPS_PER_S if dtype == torch.bfloat16
                else F32_3XTF32_OPS_PER_S))
        del x, dt, Bm, Cm, dy, ds
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_wkv_bwd_kernel(torch, R, WKV, card):
    """``wkv_bwd`` (``csrc/wkv_bwd.cu``) against ``wkv_bwd_plain`` at
    rwkv6-7b's train microbatch (JAX's chunk rule: chunks of 64) at the
    default init's decay, where the 1e-30 floor binds from step 57 and
    JAX's own gradient is NaN, and at real decays with a final-state
    gradient, at the smoke width, and at T 160 (two chunks of 80: the
    kernel's two 64-row halves) at both decays; float32, the products at
    3xTF32's rate."""
    g = torch.Generator(device=card).manual_seed(12)
    out = {}
    for name, B, T, H, P, regime, with_state in WKV_BWD_CASES:
        shape = (B, T, H * P)
        r, k, v, dy = (torch.randn(shape, generator=g, device=card)
                       for _ in range(4))
        w = (torch.full(shape, CLAMPED_W, device=card) if regime == "clamped"
             else torch.rand(shape, generator=g, device=card) * 0.149 + 0.85)
        u = torch.randn((H, P), generator=g, device=card) * 0.1
        ds = (torch.randn((B, H, P, P), generator=g, device=card)
              if with_state else None)
        Lc = R.chunk_len(T)
        # r, k, v, w, dy read, dr, dk, dv, dw written; u, du; dstate
        nbytes = 4 * (9 * r.numel() + 2 * u.numel()
                      + (ds.numel() if with_state else 0))
        out[name] = dict(
            shape=f"B{B} T{T} H{H} P{P} chunk{Lc} float32 {regime}"
                  + (" dstate" if with_state else ""),
            **_scan_bwd_case(
                torch, WKV, f"wkv_bwd {name}", (r, k, v, w, u, H, Lc), dy,
                ds, WKV.wkv_bwd, WKV.wkv_bwd_plain, WKV_GRADS, "float32",
                nbytes, _wkv_bwd_flops(B, T, H, P, Lc),
                F32_3XTF32_OPS_PER_S))
        del r, k, v, w, dy, ds
        gc.collect()
        torch.cuda.empty_cache()
    return out


TRAIN_SCAN_STEPS = 10
RWKV6_TRAIN_LAYERS = 4


def _launch_plan(cfg, FA, lib, micro):
    """The launches ``micro`` microbatches of ``train_loss`` under remat
    make: every layer's scan forward once, twice where remat recomputes it
    (the repeated pattern, not the tail), its backward once (its calls'
    launches); the shared attention block's flash forward and backward the
    same way where it runs."""
    scanned = len(cfg.pattern) * cfg.repeats
    specs = cfg.layer_specs()
    runs = [2 if i < scanned else 1 for i in range(len(specs))]
    attn = [n for n, s in zip(runs, specs) if s.kind == "mamba_shared_attn"]
    return {"scan": micro * sum(runs),
            "scan_bwd": micro * len(specs) * lib.BWD_LAUNCHES_PER_CALL,
            "flash": micro * sum(attn),
            "flash_bwd": micro * len(attn) * FA.BWD_LAUNCHES_PER_CALL}


def phase_train_scan(torch, card, FA, lib, tag, cfg, fn_name, fwd_name,
                     fwd_plain, bwd, bwd_plain):
    """``cfg`` (random weights seeded 0) trained by the launcher's
    ``train_loop`` for TRAIN_SCAN_STEPS steps on ``SyntheticLM(seq 1,024,
    global batch 8, seed 0)``: remat, accum 2, int8 compression, lr 6e-4
    with the launcher's warmup (``train_and_check``); the scan's and the
    flash kernels' counts set to 0 before and read after, each held to
    ``_launch_plan``; the
    loss finite and falling (mean of the last five steps below the first
    five's); step ms, tokens/s, peak memory, one more step profiled (busy
    share, the scan backward's and forward's shares of device time); then
    on one microbatch a float32 copy's gradients with the scan (``lib``'s
    ``fn_name``) swapped for a ``scan_function`` that takes each direction
    from its kernel or its plain version: the backward kernel against
    ``bwd_plain`` on the plain forward and on the kernel forward, the
    forward kernel alone, and both kernels against both plain versions,
    each within TRAIN_GRAD_TOL of each leaf's largest value (the flash
    kernels run in every variant, so their rounding cancels; the scans'
    own readings were 2.5e-6 to 3.7e-5)."""
    from repro_torch.kernels import scan_function
    from repro_torch.models import model as TM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import batch_to_device

    model, opt, nums = train_and_check(
        torch, card, tag, cfg, TRAIN_SCAN_STEPS,
        {"scan": (lib, "launches"), "scan_bwd": (lib, "bwd_launches"),
         "flash": (FA, "launches"), "flash_bwd": (FA, "bwd_launches")},
        _launch_plan(cfg, FA, lib, TRAIN_ACCUM * TRAIN_SCAN_STEPS))

    step_fn = make_train_step(model, AdamWConfig(lr=6e-4), accum=TRAIN_ACCUM,
                              remat=True, compress=True,
                              schedule_kwargs={"warmup": 10,
                                               "total": TRAIN_SCAN_STEPS})
    batch = launcher_batch(cfg, TRAIN_SCAN_STEPS)
    prof_nums, opt = profiled_step(torch, step_fn, opt, batch, {
        "scan_bwd": (f"{fwd_name}_bwd_",),
        "scan_fwd": (f"{fwd_name}_kernel", f"{fwd_name}_sm90_kernel"),
        "flash": ("flash_", "bwd_prep", "bwd_dkdv", "bwd_dq")})
    nums.update(prof_nums)
    say(tag, part="profile", **prof_nums)
    del opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    # a float32 copy on one microbatch, the scan's directions swapped
    wide = widened(torch, model, cfg, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    wide.requires_grad_(True)
    params = list(wide.parameters())
    names = [n for n, _ in wide.named_parameters()]
    tb = batch_to_device(first_rows(batch, TRAIN_B // TRAIN_ACCUM), card)
    real = getattr(lib, fn_name)
    fwds = {"kernel": getattr(lib, fwd_name), "plain": fwd_plain}
    bwds = {"kernel": bwd, "plain": bwd_plain}

    def grads_of(how):
        setattr(lib, fn_name, scan_function(fn_name, fwds[how[0]],
                                            bwds[how[1]]))
        try:
            loss, _ = TM.train_loss(wide, tb, remat=True)
            return float(loss.detach()), torch.autograd.grad(loss, params)
        finally:
            setattr(lib, fn_name, real)

    def worst(a_grads, b_grads):
        out = (0.0, None)
        for n, a, b in zip(names, a_grads, b_grads):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{tag} float32 gradient {n} is not "
                                     "finite")
            rel = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
            if rel >= out[0]:
                out = (rel, n)
        return out

    lib.launches, lib.bwd_launches = 0, 0
    loss_k, g_kernel = grads_of(("kernel", "kernel"))
    f32_counts = {"scan": lib.launches, "scan_bwd": lib.bwd_launches}
    want = _launch_plan(cfg, FA, lib, 1)
    if f32_counts != {k: want[k] for k in f32_counts}:
        raise AssertionError(f"{tag} float32 copy launches {f32_counts}")
    loss_p, g_plain = grads_of(("plain", "plain"))
    _, g_bwd_kernel = grads_of(("plain", "kernel"))
    _, g_fwd_kernel = grads_of(("kernel", "plain"))
    path, path_leaf = worst(g_kernel, g_plain)
    bwd_alone, bwd_leaf = worst(g_bwd_kernel, g_plain)
    bwd_on_kernel_fwd, bwd_fwd_leaf = worst(g_kernel, g_fwd_kernel)
    fwd_alone, fwd_leaf = worst(g_fwd_kernel, g_plain)
    cons = dict(float32_loss_kernel=loss_k, float32_loss_plain=loss_p,
                float32_grad_worst_rel_err=path,
                float32_grad_worst_leaf=path_leaf,
                bwd_kernel_alone_worst_rel_err=bwd_alone,
                bwd_kernel_alone_worst_leaf=bwd_leaf,
                bwd_kernel_on_kernel_forward_worst_rel_err=bwd_on_kernel_fwd,
                bwd_kernel_on_kernel_forward_worst_leaf=bwd_fwd_leaf,
                fwd_kernel_alone_worst_rel_err=fwd_alone,
                fwd_kernel_alone_worst_leaf=fwd_leaf,
                **{f"float32_{k}_launches": v for k, v in f32_counts.items()})
    say(tag, part="float32_grads", **cons)
    for what, err, leaf in (
            ("backward kernel alone", bwd_alone, bwd_leaf),
            ("backward kernel on the kernel forward", bwd_on_kernel_fwd,
             bwd_fwd_leaf),
            ("forward kernel alone", fwd_alone, fwd_leaf),
            ("kernel path vs plain", path, path_leaf)):
        if not err <= TRAIN_GRAD_TOL:
            raise AssertionError(f"{tag} float32 gradients, {what}: {err} "
                                 f"at {leaf}, past {TRAIN_GRAD_TOL}")
    nums.update(cons)
    del wide, params, g_kernel, g_plain, g_fwd_kernel, g_bwd_kernel
    gc.collect()
    torch.cuda.empty_cache()
    return nums


def phase_train_zamba2(torch, card, FA, SSD):
    """zamba2-1.2b at full size (38 layers, d 2,048, 64 SSD heads of P 64,
    N 64, the shared attention block six times; ~1.2 B parameters) through
    ``phase_train_scan``: the SSD scan forward on ``ssd_sm90`` (float32
    copy: ``ssd.cu``), its backward on ``ssd_bwd_sm90``."""
    from repro_torch.configs import get_config

    return phase_train_scan(torch, card, FA, SSD, "train_zamba2",
                            get_config("zamba2-1.2b"), "SSDScan", "ssd",
                            SSD.ssd_plain, SSD.ssd_bwd, SSD.ssd_bwd_plain)


def phase_train_rwkv6(torch, card, FA, WKV):
    """rwkv6-7b at full width (d 4,096, 64 heads of 64, d_ff 14,336, vocab
    65,536) on its first RWKV6_TRAIN_LAYERS of 32 layers (~1.41 B
    parameters: the whole model's ~7.5 B with AdamW's state would not fit
    one card) through ``phase_train_scan``: the WKV scan forward on
    ``wkv.cu``, its backward on ``wkv_bwd.cu``."""
    from repro_torch.configs import get_config

    cfg = first_layers(get_config("rwkv6-7b"), RWKV6_TRAIN_LAYERS)
    return phase_train_scan(torch, card, FA, WKV, "train_rwkv6", cfg,
                            "WKVScan", "wkv", WKV.wkv_plain, WKV.wkv_bwd,
                            WKV.wkv_bwd_plain)


# The last three families train at full width on their first layer: one
# card does not hold two with AdamW's state.  A step holds ~24 bytes a
# parameter with int8 compression (bf16 weights; float32 master, m, v,
# gradients and carried errors; a gradient's bf16 copy) and the
# activations: qwen2-vl's first layer and lm_head, 2.12 B parameters,
# peaked at 59.9 GB.  The MoE keeps top-k but fewer experts: qwen3-moe 64
# of 128 (2.49 B parameters, 67.5 GB), dbrx 8 of 16 (2.91 B, 72.5 GB;
# 60.9 GB without compression), under 90% of the card's 85.0 GB (NVIDIA
# H100 80GB HBM3).
# tag, arch, experts (None: as published)
TRAIN_FAMILIES = [("qwen3moe", "qwen3-moe-235b-a22b", 64),
                  ("dbrx", "dbrx-132b", 8),
                  ("qwen2vl", "qwen2-vl-72b", None)]
# a step's kernels of indexing, sorting, scanning and scatter / gather: the
# MoE's routing and dispatch (the top-k sort, the positions' cumsum, the
# one-hot, the buffer's fill and the gather back, and their gradients),
# and the few small gathers of the loss and the token embedding
DISPATCH_KEYS = ("index", "Index", "sort", "Sort", "scan", "Scan",
                 "scatter", "gather")
# the float32 copy's rows: half a microbatch, to keep the script near 800 s
TRAIN_F32_ROWS = 2


def train_cut(cfg, experts):
    """``cfg`` on its first layer, an MoE with ``experts`` experts (more
    than top-k, which it keeps)."""
    cfg = first_layers(cfg, 1)
    if not experts:
        return cfg
    if experts <= cfg.experts_per_tok:
        raise ValueError(f"{experts} experts route every token to all")
    return dataclasses.replace(cfg, num_experts=experts)


def grads_twice(torch, model, batch):
    """``model``'s loss and gradients on ``batch`` twice from the same
    weights (what could differ between two runs of a train step: AdamW and
    the compression are elementwise): whether they agree bit for bit, the
    leaves that do not and the largest difference over a leaf's largest
    value."""
    from repro_torch.models import model as TM

    named = dict(model.named_parameters())
    runs = []
    for _ in range(2):
        loss, _ = TM.train_loss(model, batch, remat=True)
        runs.append((loss.detach(), torch.autograd.grad(
            loss, list(named.values()))))
    (l0, g0), (l1, g1) = runs
    differ = {n: float((a.float() - b.float()).abs().max()
                       / b.float().abs().max().clamp_min(1e-30))
              for n, a, b in zip(named, g0, g1) if not torch.equal(a, b)}
    return dict(repeat_loss_bitwise_equal=bool(torch.equal(l0, l1)),
                repeat_grads_bitwise_equal=not differ,
                repeat_leaves_differing=json.dumps(differ))


def phase_train_family(torch, np, card, FA, tag, cfg):
    """``cfg`` (full width; ``train_cut``) through ``train_and_check`` for
    TRAIN_SCAN_STEPS steps: the flash forward twice a layer a microbatch under remat and one backward
    call a layer a microbatch, all on the wgmma libraries; one more step
    profiled (busy share, top kernels, the flash kernels' and the
    dispatch's shares of device time, ``DISPATCH_KEYS``); an MoE's bf16
    loss and gradients on one microbatch twice from the same weights,
    compared bit for bit (``grads_twice``); then on TRAIN_F32_ROWS rows a
    float32 copy's gradients with the flash directions swapped
    (``flash_swapped_grads``; an MoE's runs on the first run's routing,
    layer by layer through remat's recomputes; qwen2-vl's at an image's
    grid positions, so that its three M-RoPE streams differ), held by
    ``check_flash_swapped``."""
    from repro_torch.models.routing import PinnedRouting
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import batch_to_device

    calls = cfg.num_layers * TRAIN_ACCUM * TRAIN_SCAN_STEPS
    fwd, bwd = 2 * calls, calls * FA.BWD_LAUNCHES_PER_CALL
    model, opt, nums = train_and_check(
        torch, card, tag, cfg, TRAIN_SCAN_STEPS, flash_counters(FA),
        dict(flash_attention=fwd, flash_bwd=bwd, flash_sm90=fwd,
             flash_bwd_sm90=bwd))
    nums.update(experts=cfg.num_experts, experts_per_tok=cfg.experts_per_tok)

    step_fn = make_train_step(model, AdamWConfig(lr=6e-4), accum=TRAIN_ACCUM,
                              remat=True, compress=True,
                              schedule_kwargs={"warmup": 10,
                                               "total": TRAIN_SCAN_STEPS})
    batch = launcher_batch(cfg, TRAIN_SCAN_STEPS)
    prof_nums, opt = profiled_step(torch, step_fn, opt, batch, {
        "flash": ("flash_", "bwd_prep", "bwd_dkdv", "bwd_dq"),
        "dispatch": DISPATCH_KEYS})
    nums.update(prof_nums)
    say(tag, part="profile", **prof_nums)
    del opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    if cfg.num_experts:
        rep = grads_twice(torch, model, batch_to_device(
            first_rows(batch, TRAIN_B // TRAIN_ACCUM), card))
        say(tag, part="repeat", **rep)
        nums.update(rep)
    rows = first_rows(batch, TRAIN_F32_ROWS)
    if cfg.mrope_sections:
        B, S = rows["labels"].shape
        rows["positions"] = mrope_grid_positions(np, B, S, QWEN2VL_GRID)
    wide = widened(torch, model, cfg, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    with PinnedRouting() as pin:
        cons = flash_swapped_grads(torch, FA, wide,
                                   batch_to_device(rows, card),
                                   pin if cfg.num_experts else None)
    say(tag, part="float32_grads", **cons)
    check_flash_swapped(cons, tag, cfg.num_layers, FA)
    nums.update(cons)
    del wide
    gc.collect()
    torch.cuda.empty_cache()
    return nums


# --------------------------------------------------------------------------
# the paper's remaining pieces and the reactive control plane
# --------------------------------------------------------------------------

TABLE2_DETERMINISTIC = ("linear_regression", "random_forest", "xgb")


def _wall(torch, fn, calls=1):
    """Seconds per call of ``fn`` on the host clock, the card drained."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls, out


def phase_paper_models(torch, np, card):
    """Figs. 6-7 and Table II on the card, through ``bench_torch_paper``.
    The resource model's per-type lines (float64) against the same fit on
    the CPU; then the five regressors at the bench's default size (its
    ``--full`` size would keep the script past its time limit), each
    fitted and timed on the card, the deterministic ones (linear,
    forest, boosting) also fitted on the CPU: their predictions must agree
    to rtol 1e-4."""
    from bench_torch_paper import resource_fits, table2_model, table2_split
    from repro_torch.core.predictors import ALL_MODELS
    from repro_torch.core.resource_model import ResourcePredictor

    cpu = torch.device("cpu")
    out = {"resource": {}, "table2": {}}
    for w, fit_s, rp, data in resource_fits(card):
        ref = ResourcePredictor(device=cpu).fit(w, *data)
        for kind in ("cpu_fits", "mem_fits"):
            a, b = getattr(rp, kind)[w], getattr(ref, kind)[w]
            if not np.allclose([a.slope, a.intercept],
                               [b.slope, b.intercept], rtol=1e-12, atol=0):
                raise AssertionError(f"{w} {kind}: card {a} != cpu {b}")
        r2c, r2m = rp.r2(w, *data)
        row = {"r2_cpu": r2c, "r2_mem": r2m,
               "slope_cpu": rp.cpu_fits[w].slope,
               "slope_mem": rp.mem_fits[w].slope, "fit_us": fit_s * 1e6}
        say("paper_models", figure="6-7", workload=w, **row)
        if min(r2c, r2m) < 0.9:
            raise AssertionError(f"{w}: QPS -> CPU/MEM not linear {row}")
        out["resource"][w] = row

    data_s, split = table2_split(card)
    Xtr, Xte, ytr, yte = split
    say("paper_models", table="II", rows=len(ytr) + len(yte),
        train=len(ytr), test=len(yte), dataset_s=data_s)
    for name, cls in ALL_MODELS.items():
        fit_s, pred_s, _, pred, e = table2_model(name, split, card,
                                                 calls=20)
        if pred.device.type != card.type:
            raise AssertionError(f"{name} predicted on {pred.device}")
        row = {"fit_s": fit_s, "predict_us": pred_s * 1e6, **e}
        if name in TABLE2_DETERMINISTIC:
            want = cls(device=cpu).fit(Xtr, ytr).predict(Xte).numpy()
            got = pred.cpu().numpy()
            row["max_rel_diff_vs_cpu"] = float(
                np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-6)))
            if not np.allclose(got, want, rtol=1e-4, atol=1e-4):
                raise AssertionError(f"{name}: card != cpu "
                                     f"({row['max_rel_diff_vs_cpu']})")
        if not np.isfinite(list(e.values())).all():
            raise AssertionError(f"{name}: {e}")
        say("paper_models", table="II", model=name, **row)
        out["table2"][name] = row
    return out


def phase_motivation(torch, np, K, card):
    """Table I on the card through ``bench_torch_paper``: 20 single-node
    rollouts of 120 ticks, one ``runqlat_hist`` launch a tick."""
    from bench_torch_paper import motivation_table

    K.launches = 0
    wall_s, table = motivation_table(card)
    launches, ticks = K.launches, 20 * 120
    for k, (mape, r2) in table.items():
        say("motivation", table="I", fit=k, mape=mape, r2=r2)
    if launches != ticks:
        raise AssertionError(f"{launches} runqlat_hist launches for "
                             f"{ticks} ticks")
    for exp in ("exp1", "exp2"):
        if not (table[f"{exp}_runqlat_resp"][1] > table[f"{exp}_cpu_resp"][1]):
            raise AssertionError(f"{exp}: runqlat does not fit RT better "
                                 f"than CPU: {table}")
    return {"table1": table, "runqlat_hist_launches": launches,
            "ticks": ticks, "ticks_per_s": ticks / wall_s}


def _run_ticks(gaps, settle=40):
    from repro_torch.cluster.state import CHUNK
    return 30 + sum(-(-g // CHUNK) * CHUNK for g in gaps) + settle


def _control_ms(loop, phases=("snapshot", "verify", "forecast", "detect",
                              "plan")):
    """Host ms per control step by phase (from the loop's PhaseTimers)."""
    s = loop.timers.summary()
    steps = max(loop.stats.steps, 1)
    ms = {p: 1e3 * s[p]["total_s"] / steps for p in phases if p in s}
    ms["step"] = sum(ms.values())
    return ms


def controlled_card_vs_cpu(torch, np, card, rf, pods, gaps, ticks):
    """One controlled 12-node ICO run on the card and on the CPU with one
    noise stream and the same forest: the same placements and actions,
    response times and reductions to rtol 1e-4."""
    from repro_torch.cluster import state as cstate
    from repro_torch.cluster.experiment import run_experiment
    from repro_torch.control import ControlLoop, scheduler_loop_config
    from repro_torch.core import ICOScheduler, InterferenceQuantifier

    cpu = torch.device("cpu")
    gen = torch.Generator(device=card).manual_seed(11)
    stream = [cstate.draw_noise(gen, 12, cstate.CHUNK)
              for _ in range(ticks // cstate.CHUNK)]
    rf_cpu = copy.copy(rf)
    rf_cpu.device = cpu
    rf_cpu.forest = {k: v.cpu() for k, v in rf.forest.items()}
    res = {}
    for dev, model, noise in (
            (card, rf, stream),
            (cpu, rf_cpu, [[to_device(cpu, n) for n in ch] for ch in stream])):
        q = InterferenceQuantifier(model.predict)
        res[dev.type] = dataclasses.asdict(run_experiment(
            ICOScheduler(q), pods, gaps, num_nodes=12, seed=7,
            control_loop=ControlLoop(q, scheduler_loop_config("ICO")),
            device=dev, noise=noise))
    a, b = res[card.type], res["cpu"]
    for f in ("placed", "rejected", "queued_retries", "mitigations"):
        if a[f] != b[f]:
            raise AssertionError(f"controlled {f}: card {a[f]} != cpu {b[f]}")
    for f in ("avg_rt", "p90_rt", "p99_rt", "predicted_reduction",
              "realized_reduction"):
        if not np.isclose(a[f], b[f], rtol=1e-4):
            raise AssertionError(f"controlled {f}: card {a[f]} != cpu {b[f]}")
    return {"mitigations": a["mitigations"], "p99_rt_card": a["p99_rt"],
            "p99_rt_cpu": b["p99_rt"],
            "predicted_reduction_card": a["predicted_reduction"],
            "predicted_reduction_cpu": b["predicted_reduction"]}


# (trace seed, sim seed): the bench's grid runs (0, 11) and (1, 12) too;
# one seed keeps the whole script inside its time limit
CONTROL_SEEDS = [(0, 7)]


def phase_control_12(torch, np, K, RT, card, rf):
    """``bench_torch_control``'s profile grid at each of ``CONTROL_SEEDS``
    (trace seed, sim seed): every scheduler without and with its
    ``scheduler_loop_config`` loop (12 nodes, ``bursty_trace(
    num_online=14)``), one ``runqlat_hist`` launch a tick; the controlled
    ICO run on the card against the CPU at (0, 7); then, per seed, ICO's
    plans without and with control replayed under 20 seeds with the fused
    kernel (one run's p99 is one noisy sample; the 20 seeds give the
    spread), each replay's entry at the run's own sim seed held to that
    run."""
    from bench_torch_control import grid_seed

    from repro_torch.cluster.experiment import bursty_trace, replay_plan_batched

    summary = {}
    for trace_seed, sim_seed in CONTROL_SEEDS:
        tag = f"{trace_seed}/{sim_seed}"
        pods, gaps = bursty_trace(num_online=14, seed=trace_seed)
        ticks = _run_ticks(gaps)
        plans: dict = {}
        K.launches = 0
        runs = grid_seed(rf, trace_seed, sim_seed, device=card, plans=plans)
        if K.launches != len(runs) * ticks:
            raise AssertionError(f"seed {tag}: {K.launches} runqlat_hist "
                                 f"launches for {len(runs)} x {ticks} ticks")
        for (name, with_control), (r, loop, wall_s) in runs.items():
            row = {"p99_rt": r.p99_rt, "avg_rt": r.avg_rt,
                   "placed": r.placed, "rejected": r.rejected,
                   "mitigations": r.mitigations, "wall_s": wall_s,
                   "predicted_reduction": r.predicted_reduction,
                   "realized_reduction": r.realized_reduction}
            if loop is not None:
                row["control_ms"] = json.dumps(_control_ms(loop))
                row["by_kind"] = json.dumps(loop.stats.by_kind)
            say("control_12", seed=tag, scheduler=name,
                control="on" if with_control else "off", **row)
            if not np.isfinite([r.avg_rt, r.p99_rt]).all() or \
                    r.placed + r.rejected != len(pods):
                raise AssertionError(f"{tag} {name} control={with_control}: "
                                     f"{r}")
            if name in ("RR", "HUP") and with_control and (
                    "migrate" in row["by_kind"]
                    or "scale_out" in row["by_kind"]):
                raise AssertionError(f"{tag}: {name} profile moved pods")
        for name in ("ICO", "RR", "HUP", "LQP"):
            off, on = runs[(name, False)][0], runs[(name, True)][0]
            say("control_12", seed=tag, scheduler=name,
                p99_off=off.p99_rt, p99_on=on.p99_rt,
                actions=on.mitigations, win=bool(on.p99_rt < off.p99_rt))
        if runs[("ICO", True)][0].mitigations == 0:
            raise AssertionError(f"seed {tag}: the ICO loop applied nothing")
        if (trace_seed, sim_seed) == (0, 7):
            same = controlled_card_vs_cpu(torch, np, card, rf, pods, gaps,
                                          ticks)
            say("control_12", seed=tag, card_vs_cpu="ICO+control", **same)

        p99 = {}
        for with_control, plan in plans.items():
            RT.launches, K.launches = 0, 0
            wall_s, rep = _wall(torch, lambda: replay_plan_batched(
                plan, sim_seeds=tuple(range(20)), window_ticks=40,
                use_fused=True, device=card))
            bticks = rep["padded_windows"] * 40
            by_seed = {e["sim_seed"]: e for e in rep["seeds"]}
            run = runs[("ICO", with_control)][0]
            p99[with_control] = np.array([by_seed[s]["p99_rt"]
                                          for s in range(20)])
            say("control_12", seed=tag,
                replay="ICO+control" if with_control else "ICO",
                seeds=20, num_windows=rep["num_windows"],
                batched_ticks=bticks, rollout_tick_launches=RT.launches,
                wall_s=wall_s, p99_mean=float(p99[with_control].mean()),
                p99_std=float(p99[with_control].std()),
                own_seed_p99=by_seed[sim_seed]["p99_rt"], run_p99=run.p99_rt)
            if RT.launches != bticks or K.launches != 0:
                raise AssertionError(
                    f"seed {tag} replay launches: rollout_tick {RT.launches} "
                    f"for {bticks} ticks, runqlat_hist {K.launches}")
            for f in ("avg_rt", "p90_rt", "p99_rt"):
                want = getattr(run, f)
                if not np.isclose(by_seed[sim_seed][f], want, rtol=1e-3):
                    raise AssertionError(
                        f"seed {tag} replay entry {sim_seed} {f} "
                        f"{by_seed[sim_seed][f]} != run {want}")
        wins = int((p99[True] < p99[False]).sum())
        say("control_12", seed=tag, replay="ICO, control on vs off",
            seeds=20, p99_wins=wins,
            p99_gain_mean=float((p99[False] - p99[True]).mean()))
        summary[tag] = {"p99_off": runs[("ICO", False)][0].p99_rt,
                        "p99_on": runs[("ICO", True)][0].p99_rt,
                        "replay_wins": wins}
    return summary


PROACTIVE_SEED = (0, 11)
# the bench's trace is 3 days; 2 keep more than a day past the ~0.9 of a
# period the leverage gate needs, and the script inside its time limit
PROACTIVE_DAYS = 2.0
# the 1,000-node fleet's arrival trace (its length is the run's depth)
ICO_1000_PODS = 300


def _unified_card_vs_cpu(torch, np, card):
    """The unified stack (ICO-F admission, the proactive loop and one shared
    service) on a one-day 12-node trace on the card and on the CPU, fed one
    noise stream drawn on the card: counts exact, response times to rtol
    1e-4.  The leverage gate is widened to 1.0 in both runs so that it
    opens early in the day (the default needs ~0.9 of a diurnal period),
    and the predicted pod runqlat is a constant (as in
    ``tests/test_torch_obs.py``): under the forest's placements the
    reactive track takes nearly every flag and few proactive ones are
    left to compare."""
    from repro_torch.cluster import state as cstate
    from repro_torch.cluster.experiment import bursty_trace, run_experiment
    from repro_torch.control import (
        ControlLoop,
        ForecastConfig,
        ForecastService,
        scheduler_loop_config,
    )
    from repro_torch.core import ICOFScheduler, InterferenceQuantifier

    cpu = torch.device("cpu")
    pods, gaps = bursty_trace(num_online=14, seed=3, burst_gap=(40, 70),
                              days=1.0)
    ticks = _run_ticks(gaps)
    gen = torch.Generator(device=card).manual_seed(13)
    stream = [cstate.draw_noise(gen, 12, cstate.CHUNK)
              for _ in range(ticks // cstate.CHUNK)]
    cfg = dataclasses.replace(scheduler_loop_config("ICO-F", proactive=True),
                              forecast=ForecastConfig(max_leverage=1.0))
    res, stats = {}, {}
    for dev, noise in (
            (card, stream),
            (cpu, [[to_device(cpu, n) for n in ch] for ch in stream])):
        q = InterferenceQuantifier(
            lambda X: torch.full((X.shape[0],), 0.1, device=X.device))
        svc = ForecastService(cfg.forecast, cfg.horizon, device=dev)
        loop = ControlLoop(q, cfg, forecast_service=svc)
        res[dev.type] = dataclasses.asdict(run_experiment(
            ICOFScheduler(q), pods, gaps, num_nodes=12, seed=3,
            control_loop=loop, forecast=svc, control_window=40, device=dev,
            noise=noise))
        stats[dev.type] = dataclasses.asdict(loop.stats)
    a, b = res[card.type], res["cpu"]
    for f in ("placed", "rejected", "queued_retries", "mitigations",
              "proactive_mitigations"):
        if a[f] != b[f]:
            raise AssertionError(f"unified {f}: card {a[f]} != cpu {b[f]}")
    for f in ("hotspots_flagged", "proactive_flagged", "by_kind"):
        if stats[card.type][f] != stats["cpu"][f]:
            raise AssertionError(f"unified {f}: card {stats[card.type][f]} "
                                 f"!= cpu {stats['cpu'][f]}")
    for f in ("avg_rt", "p90_rt", "p99_rt", "predicted_reduction",
              "realized_reduction"):
        if not np.isclose(a[f], b[f], rtol=1e-4):
            raise AssertionError(f"unified {f}: card {a[f]} != cpu {b[f]}")
    if stats[card.type]["proactive_flagged"] == 0:
        raise AssertionError("the open-gate unified run raised no forecast "
                             "flag")
    return {"ticks": ticks, "mitigations": a["mitigations"],
            "proactive_mitigations": a["proactive_mitigations"],
            "proactive_flagged": stats[card.type]["proactive_flagged"],
            "p99_rt_card": a["p99_rt"], "p99_rt_cpu": b["p99_rt"]}


def phase_proactive_12(torch, np, K, card, rf):
    """``bench_torch_control``'s proactive axis at trace seed 0, sim seed
    11: ICO off / reactive / proactive and the unified stack on
    ``PROACTIVE_TRACE`` at ``PROACTIVE_DAYS`` (loop every 40 ticks), one
    ``runqlat_hist`` launch
    a tick; the unified run traced (saved to a temporary JSONL file) and
    its action chains checked from the trace; then the unified stack on
    the card against the CPU on one noise stream."""
    import tempfile

    from bench_torch_control import MODES, PROACTIVE_TRACE, proactive_seed

    from repro_torch.cluster.experiment import bursty_trace

    trace = dict(PROACTIVE_TRACE, days=PROACTIVE_DAYS)
    _, gaps = bursty_trace(seed=PROACTIVE_SEED[0], **trace)
    ticks = _run_ticks(gaps)
    K.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        row = proactive_seed(rf, *PROACTIVE_SEED, device=card,
                             trace_path=os.path.join(tmp, "unified.jsonl"),
                             trace=trace)
    if K.launches != len(MODES) * ticks:
        raise AssertionError(f"{K.launches} runqlat_hist launches for "
                             f"{len(MODES)} x {ticks} ticks")
    nums = {}
    for mode in MODES:
        r, loop, svc, wall_s = row["runs"][mode]
        m = {"p99_rt": r.p99_rt, "avg_rt": r.avg_rt, "placed": r.placed,
             "rejected": r.rejected, "mitigations": r.mitigations,
             "proactive_mitigations": r.proactive_mitigations,
             "wall_s": wall_s, "ticks_per_s": ticks / wall_s}
        if loop is not None:
            s = loop.stats
            m.update(proactive_flagged=s.proactive_flagged,
                     hotspots_flagged=s.hotspots_flagged,
                     control_ms=json.dumps(_control_ms(loop)))
        if loop is not None and loop.forecaster is not None:
            m["forecast_calibration"] = loop.forecaster.calibration_error()
            if loop.forecaster.A.device.type != card.type:
                raise AssertionError(f"{mode}: the forecaster ran on "
                                     f"{loop.forecaster.A.device}")
        say("proactive_12", mode=mode, ticks=ticks, **m)
        nums[mode] = m
        if not np.isfinite([r.avg_rt, r.p99_rt]).all():
            raise AssertionError(f"{mode}: {r}")
    if nums["proactive"]["proactive_flagged"] == 0:
        raise AssertionError("the proactive mode raised no forecast flag")
    if not np.isfinite(nums["proactive"]["forecast_calibration"]):
        raise AssertionError("no forecaster calibration error")
    tr = row["trace"]
    say("proactive_12", trace=tr["path"], events=tr["events"],
        executed=tr["executed"], trust_gate_events=tr["trust_gate_events"],
        chain_ok=tr["chain_ok"])
    if not tr["chain_ok"] or tr["trust_gate_events"] == 0:
        raise AssertionError(f"unified trace: {tr}")
    same = _unified_card_vs_cpu(torch, np, card)
    say("proactive_12", card_vs_cpu="unified, open gate", **same)
    r, loop, svc, _ = row["runs"]["off"]
    return {"modes": {m: {k: nums[m][k] for k in (
                "p99_rt", "mitigations", "proactive_mitigations")}
                      for m in MODES},
            "off": {"result": r, "loop": loop, "service": svc,
                    "trace": trace, "seeds": PROACTIVE_SEED,
                    "forest": rf}}


def phase_unified_1000(torch, np, K, card, rf, fleet, pods, gaps, tps):
    """Phase 4's 1,000-node fleet and arrival trace under ICO-F with the
    proactive ICO-F loop, the scheduler and the loop sharing one
    ``ForecastService``, the loop stepped every 40 ticks.  ``tps`` holds
    ``ico_1000``'s and ``control_1000``'s ticks/s from this run."""
    from repro_torch.cluster.experiment import run_experiment
    from repro_torch.control import (
        ControlLoop,
        ForecastService,
        scheduler_loop_config,
    )
    from repro_torch.core import ICOFScheduler, InterferenceQuantifier

    q = InterferenceQuantifier(rf.predict)
    cfg = scheduler_loop_config("ICO-F", proactive=True)
    svc = ForecastService(cfg.forecast, cfg.horizon, device=card)
    loop = ControlLoop(q, cfg, forecast_service=svc)
    ticks = _run_ticks(gaps)
    K.launches = 0
    wall_s, res = _wall(torch, lambda: run_experiment(
        ICOFScheduler(q), pods, gaps, fleet=fleet, seed=7, control_loop=loop,
        forecast=svc, control_window=40, device=card))
    launches = K.launches
    s = loop.stats
    f = svc.forecaster
    t_fut = svc._last_t + svc.horizon * svc._dt
    trusted_nodes = int(f.confidence(t_fut).any(-1).sum())
    steps = max(s.steps, 1)
    nums = {"ticks": ticks, "ticks_per_s": ticks / wall_s, **tps,
            "steps": s.steps, "forecast_ms_per_step":
                1e3 * loop.timers.totals.get("forecast", 0.0) / steps,
            "control_ms": json.dumps(_control_ms(loop)),
            "trusted_nodes_at_end": trusted_nodes,
            "proactive_flagged": s.proactive_flagged,
            "hotspots_flagged": s.hotspots_flagged,
            "actions": s.actions_applied,
            "proactive_actions": s.proactive_applied,
            "by_kind": json.dumps(s.by_kind),
            "forecast_calibration": f.calibration_error(),
            "avg_rt": res.avg_rt, "p90_rt": res.p90_rt, "p99_rt": res.p99_rt,
            "placed": res.placed, "rejected": res.rejected,
            "runqlat_hist_launches": launches}
    if launches != ticks:
        raise AssertionError(f"{launches} runqlat_hist launches for {ticks} "
                             "ticks")
    for k in ("A", "b", "err", "count"):
        if getattr(f, k).device.type != card.type:
            raise AssertionError(f"forecaster {k} on {getattr(f, k).device}")
    if res.placed + res.rejected != len(pods) or \
            not np.isfinite([res.avg_rt, res.p99_rt]).all():
        raise AssertionError(f"bad unified run {res}")
    return nums


def phase_control_1000(torch, np, K, card, rf, fleet, pods, gaps,
                       ico_ticks_per_s):
    """The 1,000-node ICO run of ``ico_1000`` with the ICO control loop,
    stepped every 40 ticks."""
    from repro_torch.cluster.experiment import run_experiment
    from repro_torch.control import ControlLoop, scheduler_loop_config
    from repro_torch.core import ICOScheduler, InterferenceQuantifier

    q = InterferenceQuantifier(rf.predict)
    loop = ControlLoop(q, scheduler_loop_config("ICO"))
    ticks = _run_ticks(gaps)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    K.launches = 0
    wall_s, res = _wall(torch, lambda: run_experiment(
        ICOScheduler(q), pods, gaps, fleet=fleet, seed=7, control_loop=loop,
        control_window=40, device=card))
    launches = K.launches
    s = loop.stats
    nums = {"ticks": ticks, "ticks_per_s": ticks / wall_s,
            "ico_1000_ticks_per_s": ico_ticks_per_s,
            "steps": s.steps, "hotspots_flagged": s.hotspots_flagged,
            "actions": s.actions_applied,
            "by_kind": json.dumps(s.by_kind),
            "verified": s.actions_verified,
            "discarded": s.verifications_discarded,
            "predicted_reduction": s.predicted_reduction,
            "realized_reduction": s.realized_reduction,
            "control_ms": json.dumps(_control_ms(loop)),
            "rollout_s": loop.timers.totals["rollout"],
            "avg_rt": res.avg_rt, "p90_rt": res.p90_rt,
            "p99_rt": res.p99_rt, "placed": res.placed,
            "rejected": res.rejected,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "memory_allocated_at_start": held,
            "runqlat_hist_launches": launches}
    if launches != ticks:
        raise AssertionError(f"{launches} runqlat_hist launches for "
                             f"{ticks} ticks")
    if loop.detector.device.type != card.type:
        raise AssertionError(f"the detector ran on {loop.detector.device}")
    if res.placed + res.rejected != len(pods) or \
            not np.isfinite([res.avg_rt, res.p99_rt]).all():
        raise AssertionError(f"bad controlled run {res}")
    return nums


def phase_schedulers(torch, np, K, RT, card, rf):
    """``bench_torch_schedulers``' headline and batched axis at the bench's
    fast size (40 pods, 12 nodes, ``BATCHED_SIM_SEEDS``), phase 4's forest
    for both, so the axis replays the headline runs' own plans: one
    ``runqlat_hist`` launch a headline tick, one ``rollout_tick`` launch
    per batched tick of each replay, each seed-7 entry its headline run."""
    from bench_torch_schedulers import (
        TRACE_SEED,
        batched_axis,
        headline,
    )

    from repro_torch.cluster.experiment import _arrival_trace

    n_pods = 40
    _, gaps = _arrival_trace(n_pods, seed=TRACE_SEED)
    ticks = _run_ticks(gaps)
    out, doc, plans = [], {"schedulers": {}}, {}
    K.launches = 0
    table = headline(out, doc, n_pods, device=card, predictor=rf,
                     plans=plans)
    hist_launches = K.launches
    RT.launches, K.launches = 0, 0
    per = batched_axis(out, doc, rf, n_pods, device=card, plans=plans)
    tick_launches, replay_hist = RT.launches, K.launches
    for name, us, derived in out:
        say("schedulers", row=name, us_per_call=us, derived=derived)
    if hist_launches != len(table) * ticks:
        raise AssertionError(f"{hist_launches} runqlat_hist launches for "
                             f"{len(table)} x {ticks} ticks")
    bticks = {name: d["replay"]["padded_windows"] * 40
              for name, d in per.items()}
    if tick_launches != sum(bticks.values()) or replay_hist != 0:
        raise AssertionError(
            f"replay launches: rollout_tick {tick_launches} for "
            f"{bticks} batched ticks, runqlat_hist {replay_hist}")
    summary = {}
    for name, r in table.items():
        d = per[name]
        if r.placed + r.rejected != n_pods or not np.isfinite(
                [r.avg_rt, r.p90_rt, r.p99_rt]).all():
            raise AssertionError(f"{name}: {r}")
        if not np.isfinite(d["p99"] + d["avg"]).all():
            raise AssertionError(f"{name} replay: {d['p99']} {d['avg']}")
        seed7 = next(e for e in d["replay"]["seeds"]
                     if e["sim_seed"] == TRACE_SEED)
        for f in ("avg_rt", "p90_rt", "p99_rt"):
            if not np.isclose(seed7[f], getattr(r, f), rtol=1e-3):
                raise AssertionError(f"{name} replay seed 7 {f} {seed7[f]} "
                                     f"!= headline {getattr(r, f)}")
        b = doc["batched"]["schedulers"][name]
        summary[name] = {
            **{f: getattr(r, f) for f in (
                "avg_rt", "p90_rt", "p99_rt", "cpu_util_std",
                "mem_util_std", "placed", "rejected")},
            **{k: b[k] for k in ("p99_mean", "p99_std", "avg_mean",
                                 "avg_std", "wins_vs_hup", "wall_s")}}
    return {"ticks": ticks, "batched_ticks": json.dumps(bticks),
            "runqlat_hist_launches": hist_launches,
            "rollout_tick_launches": tick_launches,
            "table": json.dumps(summary)}


# the exact-fallback bar's trace: half a day of the forecast trace (the
# bar holds with the gate shut as well as open)
FALLBACK_DAYS = 0.5


def phase_schedulers_forecast(torch, np, K, card, rf, off):
    """``bench_torch_schedulers``' forecast axis at its first seed on
    ``FORECAST_TRACE`` cut to ``PROACTIVE_DAYS``: ICO-F with a fresh
    ``ForecastService`` against ICO, one ``runqlat_hist`` launch a tick.
    ``off`` is ``proactive_12``'s ICO run without a loop, which is the
    axis's ICO run when its forest, trace and seeds are these (without a
    loop or a service ``control_window`` has no effect); otherwise ICO is
    run here.  Then the exact-fallback bar on ``FALLBACK_DAYS``."""
    from bench_torch_schedulers import (
        FORECAST_SEEDS,
        FORECAST_TRACE,
        NUM_NODES,
        fallback_exact,
        forecast_seed,
    )

    from repro_torch.cluster.experiment import (
        bursty_trace,
        make_schedulers,
        run_experiment,
    )

    seed = tuple(FORECAST_SEEDS[0])
    trace = dict(FORECAST_TRACE, days=PROACTIVE_DAYS)
    reuse = (off["forest"] is rf and off["trace"] == trace
             and tuple(off["seeds"]) == seed and off["loop"] is None
             and off["service"] is None
             and off["result"].scheduler == "ICO")
    _, gaps = bursty_trace(seed=seed[0], **trace)
    ticks = _run_ticks(gaps)
    short = dict(FORECAST_TRACE, days=FALLBACK_DAYS)
    pods_s, gaps_s = bursty_trace(seed=seed[0], **short)
    K.launches = 0
    row = forecast_seed(rf, *seed, device=card, trace=trace, ico=not reuse)
    ico = off["result"] if reuse else row["ico"]
    icof, svc = row["icof"], row["service"]
    r_ico_s = run_experiment(make_schedulers(rf, forecast=True)["ICO"],
                             pods_s, gaps_s, num_nodes=NUM_NODES,
                             seed=seed[1], device=card)
    exact = fallback_exact(rf, pods_s, gaps_s, seed[1], r_ico_s,
                           device=card)
    launches = K.launches
    want = (1 if reuse else 2) * ticks + 2 * _run_ticks(gaps_s)
    f = svc.forecaster
    t_fut = svc._last_t + svc.horizon * svc._dt
    nums = {"trace_seed": seed[0], "sim_seed": seed[1], "days": trace["days"],
            "ticks": ticks, "ico_reused_from_proactive_12": reuse,
            "p99_ico": ico.p99_rt, "p99_icof": icof.p99_rt,
            "avg_ico": ico.avg_rt, "avg_icof": icof.avg_rt,
            "p90_ico": ico.p90_rt, "p90_icof": icof.p90_rt,
            "placed_ico": ico.placed, "placed_icof": icof.placed,
            "win": bool(icof.p99_rt <= ico.p99_rt),
            "forecast_seed_wall_s": row["wall_s"],
            "trusted_nodes_at_end": int(f.confidence(t_fut).any(-1).sum()),
            "fallback_days": FALLBACK_DAYS, "fallback_exact": exact,
            "fallback_p99": r_ico_s.p99_rt,
            "runqlat_hist_launches": launches}
    if launches != want:
        raise AssertionError(f"{launches} runqlat_hist launches for {want} "
                             "ticks")
    for k in ("A", "b", "err", "count"):
        if getattr(f, k).device.type != card.type:
            raise AssertionError(f"forecaster {k} on {getattr(f, k).device}")
    for r in (ico, icof, r_ico_s):
        if r.placed + r.rejected == 0 or not np.isfinite(
                [r.avg_rt, r.p99_rt]).all():
            raise AssertionError(f"bad forecast-axis run {r}")
    if not exact:
        raise AssertionError("ICO-F without a service is not ICO")
    return nums


def phase_scheduler_latency(torch, np, K, card):
    """``bench_torch_scheduler_latency``'s ``--full`` sweep (128 / 1,000 /
    5,000 nodes, 40 repetitions) with JAX's CI bound (ICO and ICO-F
    5,000-node p99 within 10x of their 128-node p99), ICO's and HUP's
    admissions at 5,000 nodes profiled, then ``--timers`` (one
    ``runqlat_hist`` launch a tick of its 8-node cluster)."""
    from bench_torch_scheduler_latency import (
        SIZES_FULL,
        _fleet_view,
        _pod,
        _schedulers,
        phase_timers,
        sweep,
    )

    out: list = []
    res = sweep(SIZES_FULL, 40, device=card, out=out)
    for name, by_n in res.items():
        say("scheduler_latency", scheduler=name, **{
            f"n{n}_{k}": v[k] for n, v in by_n.items()
            for k in ("mean_us", "p99_us", "selected")})
    ratios = {name: res[name]["5000"]["p99_us"] / res[name]["128"]["p99_us"]
              for name in res}
    say("scheduler_latency", p99_ratio_5000_128=json.dumps(ratios))
    for name in ("ICO", "ICO-F"):
        if not ratios[name] <= 10.0:
            raise AssertionError(f"{name}: 5,000-node p99 "
                                 f"{ratios[name]:.2f}x the 128-node p99")
    view, pod, scheds = _fleet_view(5000, device=card), _pod(), _schedulers()
    for name in ("ICO", "HUP"):
        sched = scheds[name]
        sched.select_node(pod, view)
        say("scheduler_latency", profile=name, nodes=5000,
            **device_profile(torch, lambda sched=sched: [
                sched.select_node(pod, view) for _ in range(20)],
                20, "admission"))
    tout: list = []
    K.launches = 0
    tim = phase_timers(tout, device=card)
    launches = K.launches
    ticks = 30 + 10 * 10 + 2 * 11 * 40 + 30 * 40
    for name, us, derived in tout:
        say("scheduler_latency", row=name, us_per_call=us, derived=derived)
    if launches != ticks:
        raise AssertionError(f"--timers: {launches} runqlat_hist launches "
                             f"for {ticks} ticks")
    return {"ico_p99_ratio": ratios["ICO"], "icof_p99_ratio": ratios["ICO-F"],
            "timer_ticks": ticks, "runqlat_hist_launches": launches,
            "rollout_ms": json.dumps(tim["rollout_ms"]),
            "phase_mean_ms": json.dumps({p: s["mean_ms"]
                                         for p, s in tim["phases"].items()})}


# the 12-node row of ``rollout_scale``, cut from the bench's 3 days (the
# full grid runs through the bench itself)
ROLLOUT_SCALE_DAYS = 0.25


def phase_rollout_scale(torch, np, K, RT, card):
    """``bench_torch_rollout_scale``'s 1,000-node 0.1-day sample row (2
    seeds) and its 12-node row at ``ROLLOUT_SCALE_DAYS`` (20 seeds), each
    cold then warm with the fused tick: one ``rollout_tick`` launch per
    batched tick, no ``runqlat_hist`` launch."""
    from bench_torch_rollout_scale import WINDOW_TICKS, scenario_row

    RT.launches, K.launches = 0, 0
    want = 0
    for days, nodes in ((0.1, 1000), (ROLLOUT_SCALE_DAYS, 12)):
        rec, p99 = scenario_row(days, nodes, device=card)
        want += 2 * rec["windows"] * WINDOW_TICKS
        say("rollout_scale", **rec, p99_mean=float(np.mean(p99)),
            p99_std=float(np.std(p99)))
        if not np.isfinite(p99).all() or min(p99) <= 0:
            raise AssertionError(f"{rec['scenario']}: p99 {p99}")
    launches, hist = RT.launches, K.launches
    if launches != want or hist != 0:
        raise AssertionError(f"rollout_tick {launches} launches for {want} "
                             f"batched ticks, runqlat_hist {hist}")
    return {"batched_ticks": want, "rollout_tick_launches": launches}


# (tag, arch, shortest and longest prompt, layers served (None: all), layers
# of the float32 kernel-vs-plain copy (None: all)).  gemma3's prompts pass
# its 1,024-token window, so the window binds in prefill and in decode;
# the MoE models keep the depth whose bf16 weights fit one card beside
# their caches (8 of qwen3's 94 layers, 6 of dbrx's 40: ~42 GB each); the
# dense ones half their depth or less (17 of gemma3's 34 layers, two of
# them global; 12 of internlm2's 48, 12 of deepseek's 62 and 8 of rwkv6's
# 32, 24, 31 and 16 until the MoE training phases came), to keep the whole
# script near 800 s
RWKV6_SERVE_LAYERS = 8
SERVE_FAMILIES = [
    ("gemma3", "gemma3-4b", 1025, 2048, 17, None),
    ("internlm2", "internlm2-20b", 256, 1024, 12, 2),
    ("deepseek33b", "deepseek-coder-33b", 256, 1024, 12, 2),
    ("qwen3moe", "qwen3-moe-235b-a22b", 256, 1024, 8, 2),
    ("dbrx", "dbrx-132b", 256, 1024, 6, 2),
]


def _load_file(rel):
    """A module of the checkout by path (an example or a bench)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)
    spec = importlib.util.spec_from_file_location(
        "_cs_" + os.path.basename(rel)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_metric_pipeline(torch, K, card):
    """``benchmarks/bench_torch_metric_pipeline.py`` on the card, at 1,000
    and (``--full``) 4,000 nodes x 14 series x 256 samples: its rows (CUDA
    events), every sample binned once, the histograms equal to the plain
    version's on the same samples, ``runqlat_hist`` launches counted."""
    bench = _load_file("benchmarks/bench_torch_metric_pipeline.py")
    out = {}
    for full in (False, True):
        K.launches = 0
        res = bench.run(device=card, full=full)
        torch.cuda.synchronize()
        tag = "full" if full else "fast"
        plain = K.runqlat_hist_plain(res["input"].reshape(-1, 256))
        if not torch.equal(res["hist"].reshape(-1, 200), plain):
            raise AssertionError(f"metric pipeline {tag}: kernel != plain")
        if res["binned"] != res["samples"] or K.launches == 0:
            raise AssertionError(f"metric pipeline {tag}: {res['binned']} "
                                 f"binned of {res['samples']}, "
                                 f"{K.launches} launches")
        if not bool(torch.isfinite(res["intf"]).all()):
            raise AssertionError(f"metric pipeline {tag}: non-finite Eq. 1")
        out[f"{tag}_nodes"] = res["nodes"]
        out[f"{tag}_runqlat_hist_launches"] = K.launches
        for name, us, derived in res["rows"]:
            out[f"{tag}_{name.split('.')[-1]}_us"] = us
            out[f"{tag}_{name.split('.')[-1]}_derived"] = derived
    return out


def phase_colocation(torch, K, FA, card):
    """``examples/torch_colocation_sim.py`` on the card: ``--selftest`` (one
    traced admission), then the demo (the predictor trained, 14 pods placed
    by ICO with every admission traced, the smollm-135m smoke model served,
    Eq. 1 of its runqlat histogram).  The smoke model has hd 16, so its
    prefills launch the bf16 wgmma flash kernel, one launch a layer a
    cohort."""
    from repro_torch.configs import get_smoke_config

    demo = _load_file("examples/torch_colocation_sim.py")
    if demo.selftest(device=card) != 1:
        raise AssertionError("colocation selftest traced no admission")
    K.launches, FA.launches = 0, 0
    t0 = time.perf_counter()
    res = demo.main(device=card)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    placed = sum(node >= 0 for _, node in res["placements"])
    stats = res["serve"]
    cohorts = -(-stats["finished"] // 4)
    layers = get_smoke_config("smollm-135m").num_layers
    if len(res["placements"]) != 14 or placed == 0 or not res["admissions"]:
        raise AssertionError(f"colocation placements {res['placements']}")
    if stats["finished"] != 8 or not math.isfinite(res["intf"]):
        raise AssertionError(f"colocation serve {stats} intf {res['intf']}")
    if FA.launches != cohorts * layers or K.launches == 0:
        raise AssertionError(f"colocation launches: flash {FA.launches} "
                             f"for {cohorts} cohorts, runqlat_hist "
                             f"{K.launches}")
    return dict(main_wall_s=wall, pods=len(res["placements"]), placed=placed,
                admissions_traced=res["admissions"],
                served=stats["finished"],
                serve_avg_latency_s=stats["avg_latency"],
                serve_runqlat_avg=stats["runqlat_avg"], eq1_intf=res["intf"],
                flash_attention_launches=FA.launches,
                runqlat_hist_launches=K.launches)


def cluster_paths(torch, build, card, timers, done) -> dict:
    """Phases 2-19: the cluster, replay and control-plane paths.  Returns
    the numbers the kernels line needs; everything they held on the card
    is released when this returns."""
    import numpy as np

    from repro_torch.cluster import state as cstate
    from repro_torch.cluster import workloads as W
    from repro_torch.cluster import experiment as texp
    from repro_torch.cluster.experiment import (
        _arrival_trace,
        replay_plan_batched,
        run_experiment,
        train_default_predictor,
    )
    from repro_torch.cluster.fleet import make_fleet
    from repro_torch.cluster.simulator import Cluster
    from repro_torch.cluster.workloads import Pod
    from repro_torch.core import ICOScheduler, InterferenceQuantifier
    from repro_torch.kernels import rollout_tick as RT
    from repro_torch.kernels import runqlat_hist as K

    cpu = torch.device("cpu")

    # 2. kernel against its plain version ---------------------------------
    with timers.phase("kernel"):
        knums = phase_kernel(torch, K, build, card)
    done("kernel")

    # 3. ten ticks at 1,000 nodes, card vs CPU, one noise bundle ----------
    with timers.phase("ticks"):
        c = loaded_cluster(Cluster, make_fleet, Pod, W, 1000, card)
        noise = cstate.draw_noise(torch.Generator(device=card).manual_seed(3),
                                  c.n, cstate.CHUNK)
        gst, gout = cstate._window_core(c.state, c.profiles, c.fleet_params,
                                        0.0, noise)
        cst, cout = cstate._window_core(
            to_device(cpu, c.state),
            {k: v.cpu() for k, v in c.profiles.items()},
            to_device(cpu, c.fleet_params), 0.0,
            [to_device(cpu, n) for n in noise])
        for k, v in vars(gst).items():
            if not torch.equal(v.cpu(), getattr(cst, k)):
                raise AssertionError(f"tick state {k}: card != cpu")
        moved, worst = 0.0, 0.0
        for k, v in gout.items():
            v = v.cpu()
            if k.startswith("hist"):
                if not torch.equal(v.sum(-1), cout[k].sum(-1)):
                    raise AssertionError(f"{k} totals: card != cpu")
                moved += float((v - cout[k]).abs().sum()) / 2
            else:
                if not torch.allclose(v, cout[k], rtol=1e-5, atol=1e-5):
                    raise AssertionError(f"tick output {k}: card != cpu")
                rel = (v - cout[k]).abs() / cout[k].abs().clamp_min(1e-5)
                worst = max(worst, float(rel.max()))
        active = int(c.state.on_active.sum() + c.state.off_active.sum())
    done("ticks", nodes=c.n, active_slots=active, samples_changed_bin=moved,
         max_rel_diff=worst)

    # 4. the main path at full width --------------------------------------
    K.launches = 0
    with timers.phase("train"):
        rf = train_default_predictor(seed=7)
        torch.cuda.synchronize()
    done("train", runqlat_hist_launches=K.launches,
         trees=int(rf.forest["feature"].shape[0]))

    fleet = make_fleet(1000, MIX, seed=0)
    pods, gaps = _arrival_trace(ICO_1000_PODS, seed=7)
    ticks = 30 + sum(-(-g // cstate.CHUNK) * cstate.CHUNK for g in gaps) + 40
    sched = ICOScheduler(InterferenceQuantifier(rf.predict))
    with timers.phase("profile"):
        phase_profile(torch, K, c, sched, pods[:20])
    done("profile")
    torch.cuda.reset_peak_memory_stats()
    held1000 = torch.cuda.memory_allocated()
    plan1000: dict = {}
    K.launches = 0
    with timers.phase("ico_1000"):
        res = run_experiment(sched, pods, gaps, fleet=fleet, seed=7,
                             plan_out=plan1000)
        torch.cuda.synchronize()
    launches = K.launches
    wall = timers.totals["ico_1000"]
    done("ico_1000", nodes=fleet.num_nodes, pods=len(pods), ticks=ticks,
         avg_rt=res.avg_rt, p90_rt=res.p90_rt, p99_rt=res.p99_rt,
         placed=res.placed, rejected=res.rejected,
         queued_retries=res.queued_retries, ticks_per_s=ticks / wall,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         memory_allocated_at_start=held1000, runqlat_hist_launches=launches)
    if launches != ticks:   # one launch a tick bins both slot kinds
        raise AssertionError(f"{launches} kernel launches for {ticks} ticks")
    if res.placed + res.rejected != len(pods) or res.placed == 0:
        raise AssertionError(f"placed {res.placed} rejected {res.rejected}")
    if not np.isfinite([res.avg_rt, res.p90_rt, res.p99_rt]).all() or \
            not 0 < res.avg_rt <= res.p90_rt <= res.p99_rt:
        raise AssertionError(f"bad response times {res}")

    # 5. Figs. 13-15: the headline table and its 20-seed batched axis -----
    with timers.phase("schedulers"):
        sch = phase_schedulers(torch, np, K, RT, card, rf)
    done("schedulers", **sch)

    # 6. a 12-node ICO run on the card and on the CPU, one noise stream ----
    with timers.phase("card_vs_cpu"):
        pods12, gaps12 = _arrival_trace(40, seed=7)
        chunks = 3 + sum(-(-g // cstate.CHUNK) for g in gaps12) + 4
        gen = torch.Generator(device=card).manual_seed(11)
        stream = [cstate.draw_noise(gen, 12, cstate.CHUNK)
                  for _ in range(chunks)]
        rf_cpu = copy.copy(rf)
        rf_cpu.device = cpu
        rf_cpu.forest = {k: v.cpu() for k, v in rf.forest.items()}
        plan12: dict = {}
        on_card = run_experiment(
            ICOScheduler(InterferenceQuantifier(rf.predict)), pods12, gaps12,
            seed=7, noise=stream, plan_out=plan12)
        on_cpu = run_experiment(
            ICOScheduler(InterferenceQuantifier(rf_cpu.predict)), pods12,
            gaps12, seed=7, device=cpu,
            noise=[[to_device(cpu, n) for n in ch] for ch in stream])
        a, b = dataclasses.asdict(on_card), dataclasses.asdict(on_cpu)
        if (a["placed"], a["rejected"]) != (b["placed"], b["rejected"]):
            raise AssertionError(f"card {a} != cpu {b}")
        for f in ("avg_rt", "p90_rt", "p99_rt"):
            if not np.isclose(a[f], b[f], rtol=1e-4):
                raise AssertionError(f"{f}: card {a[f]} != cpu {b[f]}")
    done("card_vs_cpu", placed=a["placed"], rejected=a["rejected"],
         avg_rt_card=a["avg_rt"], avg_rt_cpu=b["avg_rt"])

    # 7. the batched engine: fused against default, card against CPU -------
    with timers.phase("engine_parity"):
        parity = phase_engine_parity(torch, cstate, texp, plan12, card)
    done("engine_parity", **parity)

    # 8. the replay path at full width: 20 seeds x 1,000 nodes -------------
    sim_seeds, window_ticks = tuple(range(20)), 40
    torch.cuda.reset_peak_memory_stats()
    K.launches = 0
    RT.launches = 0
    with timers.phase("replay_1000"):
        rep = replay_plan_batched(plan1000, sim_seeds=sim_seeds,
                                  window_ticks=window_ticks, use_fused=True)
        torch.cuda.synchronize()
    fused_launches, hist_launches = RT.launches, K.launches
    rwall = timers.totals["replay_1000"]
    bticks = rep["padded_windows"] * window_ticks
    real_ticks = int(plan1000["t_end"])   # the plan's span; the rest is padding
    p99 = np.array([e["p99_rt"] for e in rep["seeds"]])
    by_seed = {e["sim_seed"]: e for e in rep["seeds"]}
    done("replay_1000", seeds=len(sim_seeds), nodes=fleet.num_nodes,
         t_end=plan1000["t_end"], num_windows=rep["num_windows"],
         padded_windows=rep["padded_windows"], batched_ticks=bticks,
         padding_share=1 - real_ticks / bticks,
         replay_wall_s=rep["wall_s"], batched_ticks_per_s=bticks / rwall,
         node_ticks_per_s=len(sim_seeds) * bticks * fleet.num_nodes / rwall,
         real_batched_ticks_per_s=real_ticks / rwall,
         real_node_ticks_per_s=(len(sim_seeds) * real_ticks
                                * fleet.num_nodes / rwall),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         rollout_tick_launches=fused_launches,
         rollout_tick_launches_per_batched_tick=fused_launches / bticks,
         runqlat_hist_launches=hist_launches,
         p99_mean=float(p99.mean()), p99_std=float(p99.std()),
         seed7=json.dumps({k: by_seed[7][k]
                           for k in ("avg_rt", "p90_rt", "p99_rt")}),
         hot_windows=json.dumps([e["hot_windows"] for e in rep["seeds"]]))

    # 9. rollout_tick against its plain version on a replay tick -----------
    with timers.phase("fused_kernel"):
        args = capture_replay_tick(torch, cstate, texp, RT, plan1000,
                                   sim_seeds, 5000, card)
        fnums = phase_fused_kernel(torch, RT, args, card)
    done("fused_kernel", **fnums)
    if fused_launches != bticks:
        raise AssertionError(
            f"{fused_launches} rollout_tick launches for {bticks} ticks")
    if hist_launches != 0:
        raise AssertionError(f"{hist_launches} runqlat_hist launches in the "
                             "fused replay")
    for f in ("avg_rt", "p90_rt", "p99_rt"):
        if not np.isclose(by_seed[7][f], getattr(res, f), rtol=1e-3):
            raise AssertionError(
                f"replay seed 7 {f} {by_seed[7][f]} != ico_1000 "
                f"{getattr(res, f)}")
    if not np.isfinite(p99).all():
        raise AssertionError(f"bad replay p99 {p99}")

    # 10. where the batched tick's time goes -------------------------------
    with timers.phase("replay_profile"):
        prof = phase_replay_profile(torch, cstate, texp, RT, plan1000, card)
    for name, nums in prof.items():
        say("replay_profile", path=name, **nums)
    done("replay_profile")

    # 11-17. the paper's remaining pieces, the control plane, reactive and
    # proactive, and the Figs. 13-15 bench's forecast axis
    with timers.phase("paper_models"):
        phase_paper_models(torch, np, card)
    done("paper_models")
    with timers.phase("motivation"):
        mot = phase_motivation(torch, np, K, card)
    done("motivation", runqlat_hist_launches=mot["runqlat_hist_launches"],
         ticks=mot["ticks"], ticks_per_s=mot["ticks_per_s"])
    with timers.phase("control_12"):
        c12 = phase_control_12(torch, np, K, RT, card, rf)
    done("control_12", seeds=json.dumps(c12))
    with timers.phase("proactive_12"):
        p12 = phase_proactive_12(torch, np, K, card, rf)
    done("proactive_12", modes=json.dumps(p12["modes"]))
    with timers.phase("schedulers_forecast"):
        sfc = phase_schedulers_forecast(torch, np, K, card, rf, p12["off"])
    done("schedulers_forecast", **sfc)
    with timers.phase("control_1000"):
        c1000 = phase_control_1000(torch, np, K, card, rf, fleet, pods, gaps,
                                   ticks / wall)
    done("control_1000", **c1000)
    with timers.phase("unified_1000"):
        u1000 = phase_unified_1000(
            torch, np, K, card, rf, fleet, pods, gaps,
            {"ico_1000_ticks_per_s": ticks / wall,
             "control_1000_ticks_per_s": c1000["ticks_per_s"]})
    done("unified_1000", **u1000)

    # 18-19. the admission-latency and replay-throughput benches
    with timers.phase("scheduler_latency"):
        lat = phase_scheduler_latency(torch, np, K, card)
    done("scheduler_latency", **lat)
    with timers.phase("rollout_scale"):
        rsc = phase_rollout_scale(torch, np, K, RT, card)
    done("rollout_scale", **rsc)

    return dict(knums=knums, fnums=fnums,
                hist_paths={"ico_1000": launches,
                            "schedulers": sch["runqlat_hist_launches"],
                            "schedulers_forecast":
                                sfc["runqlat_hist_launches"],
                            "scheduler_latency":
                                lat["runqlat_hist_launches"]},
                tick_paths={"replay_1000": fused_launches,
                            "schedulers": sch["rollout_tick_launches"],
                            "rollout_scale": rsc["rollout_tick_launches"]})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.join(root, "src"),
                    os.path.join(root, "benchmarks")]
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import runqlat_hist as K
    from repro_torch.kernels import rwkv_wkv as WKV
    from repro_torch.kernels import ssd as SSD
    from repro_torch.models import rwkv as R
    from repro_torch.obs import PhaseTimers

    card = torch.device("cuda")
    timers = PhaseTimers()

    def done(name, **kv):
        say(name, wall_s=timers.totals[name], **kv)

    # 1. build ------------------------------------------------------------
    with timers.phase("build"):
        # the earlier kernels (timed beside their replacements) build
        # alongside, all nvcc processes at once
        earlier = threading.Thread(target=build.build,
                                   args=(["runqlat_hist", "wkv"], EARLIER))
        earlier.start()
        try:
            libs = build.build(["runqlat_hist", "rollout_tick",
                                "flash_attention", "flash_attention_sm90",
                                "flash_attention_f32_sm90",
                                "flash_attention_bwd",
                                "flash_attention_bwd_sm90",
                                "flash_attention_bwd_f32_sm90", "ssd",
                                "ssd_sm90", "ssd_bwd_sm90", "wkv",
                                "wkv_bwd"])
        finally:
            earlier.join()
        build.load("runqlat_hist", EARLIER)   # raises if that build failed
        build.load("wkv", EARLIER)
    done("build", ptxas=json.dumps({
        k: v.strip().splitlines()[-2:] for k, v in build.build_logs.items()}))
    for name in ("runqlat_hist", "rollout_tick", "ssd_sm90", "ssd_bwd_sm90",
                 "wkv", "wkv_bwd"):
        say("build", kernel=name, ptxas=json.dumps(
            ptxas_summary(build.build_logs.get(name, ""))))
    for lib in ("ssd_bwd_sm90", "wkv_bwd"):  # the scan backwards spill none
        spills = {e: v["spill_stores"] for e, v in ptxas_summary(
            build.build_logs.get(lib, "")).items() if v.get("spill_stores")}
        if spills:
            raise AssertionError(f"{lib} spills: {spills}")
    for lib in ("flash_attention_bwd", "flash_attention_bwd_sm90",
                "flash_attention_bwd_f32_sm90"):
        bwd_ptxas = ptxas_summary(build.build_logs.get(lib, ""))
        say("build", kernel=lib, entries=len(bwd_ptxas),
            max_registers=max((v.get("registers", 0)
                               for v in bwd_ptxas.values()), default=0),
            spill_stores=sum(v.get("spill_stores", 0)
                             for v in bwd_ptxas.values()))
    for lib in ("flash_attention_bwd_sm90", "flash_attention_bwd_f32_sm90"):
        log = build.build_logs.get(lib, "")
        for fn in ("bwd_dkdv_kernel", "bwd_dq_kernel"):
            inst = flash_instantiations(log, fn)
            say("build", **{f"{lib}.{fn}": json.dumps(inst)})
            if log and sorted(inst) != FLASH_WIDTHS:
                raise AssertionError(f"{lib} {fn} instantiations: {inst}")
    for lib, fn in (("flash_attention_sm90", "flash_sm90_kernel"),
                    ("flash_attention_f32_sm90", "flash_f32_kernel")):
        flash_log = build.build_logs.get(lib, "")
        inst = flash_instantiations(flash_log, fn)
        say("build", **{f"{lib}_instantiations": json.dumps(inst)})
        if flash_log and sorted(inst) != FLASH_WIDTHS:
            raise AssertionError(f"{fn} instantiations: {inst}")
    counts = {f"{lib}_{op.lower()}_instructions": sass_count(libs[lib], op)
              for lib, op in (("flash_attention_sm90", "HGMMA"),
                              ("flash_attention_f32_sm90", "HMMA"),
                              ("flash_attention_bwd_sm90", "HGMMA"),
                              ("flash_attention_bwd_f32_sm90", "HMMA"),
                              ("ssd_sm90", "HMMA"))}
    say("build", **counts)
    for key, n in counts.items():
        if n == 0:
            raise AssertionError(f"none in the SASS: {key}")

    # 2-19. the cluster, replay, control-plane and bench paths
    paths = cluster_paths(torch, build, card, timers, done)
    knums, fnums = paths["knums"], paths["fnums"]
    hist_paths, tick_paths = paths["hist_paths"], paths["tick_paths"]

    # 20-22. the serving path: both kernels, then zamba2-1.2b at full width
    # (float32 products in full float32 for every plain version)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with timers.phase("flash_kernel"):
        flash = phase_flash_kernel(torch, FA, build, card)
    for name, nums in flash.items():
        say("flash_kernel", case=name, **nums)
    done("flash_kernel")
    with timers.phase("ssd_kernel"):
        ssdk = phase_ssd_kernel(torch, SSD, build, card)
    for name, nums in ssdk.items():
        say("ssd_kernel", case=name, **nums)
    done("ssd_kernel")
    with timers.phase("serve_zamba2"):
        zcfg = get_config("zamba2-1.2b")
        serve = phase_serve(
            torch, np, card, "zamba2-1.2b",
            {"flash_attention": FA, "ssd": SSD},
            {"flash_attention": sum(s.kind == "mamba_shared_attn"
                                    for s in zcfg.layer_specs()),
             "ssd": zcfg.num_layers},
            lambda rng, n: rng.integers(256, 1025, n), "zamba2")
    done("serve_zamba2")

    # 23-24. the rwkv6-7b serving path: the wkv kernel, then the model at
    # full width and depth
    with timers.phase("wkv_kernel"):
        wkvk = phase_wkv_kernel(torch, R, build, card)
    for name, nums in wkvk.items():
        say("wkv_kernel", case=name, **nums)
    done("wkv_kernel")
    with timers.phase("serve_rwkv6"):
        rserve = phase_serve(
            torch, np, card, "rwkv6-7b", {"wkv": WKV},
            {"wkv": RWKV6_SERVE_LAYERS},
            lambda rng, n: rng.integers(4, 17, n) * 64, "rwkv6",
            check_len=64, layers=RWKV6_SERVE_LAYERS)
    done("serve_rwkv6")

    # 25. flash at every width beyond 64 and 128, gemma3-4b's prefill among
    # them: bf16 on the wgmma kernel, float32 on the 3xTF32 one, the SIMT
    # kernel timed beside each
    with timers.phase("flash_widths"):
        widths = phase_flash_widths(torch, FA, build, card)
    for name, nums in widths.items():
        say("flash_widths", case=name, **nums)
    done("flash_widths")

    # 26-30. the remaining model families at full width: gemma3-4b,
    # internlm2-20b and deepseek-coder-33b at cut depth, the MoE models at
    # the depth one card holds; the float32 kernel-vs-plain copy of the
    # large ones is their first two layers (a full float32 copy would not
    # fit beside the bf16 model)
    flash_paths = {"zamba2": serve["flash_attention_launches"]}
    f32_paths = {"zamba2": serve["float32_flash_launches"]}
    def hold_little(tag):
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        if held >= 2e9:
            raise AssertionError(f"{held} bytes held before {tag}")

    for tag, arch, lo, hi, layers, f32_layers in SERVE_FAMILIES:
        hold_little(f"serve_{tag}")
        cfg = get_config(arch)
        n = layers or cfg.num_layers
        with timers.phase(f"serve_{tag}"):
            nums = phase_serve(
                torch, np, card, arch, {"flash_attention": FA},
                {"flash_attention": n},
                lambda rng, k, lo=lo, hi=hi: rng.integers(lo, hi + 1, k),
                tag, layers=layers, f32_layers=f32_layers)
        done(f"serve_{tag}")
        flash_paths[tag] = nums["flash_attention_launches"]
        f32_paths[tag] = nums["float32_flash_launches"]

    # 31-32. the embedding-input families: qwen2-vl-72b at full width (20
    # of 80 layers) with image-grid M-RoPE positions, and hubert-xlarge's
    # non-causal encoder at full width and depth
    hold_little("serve_qwen2vl")
    with timers.phase("serve_qwen2vl"):
        vlm = phase_serve_qwen2vl(torch, np, card, FA)
    done("serve_qwen2vl")
    flash_paths["qwen2vl"] = vlm["flash_attention_launches"]
    f32_paths["qwen2vl"] = vlm["float32_flash_launches"]
    hold_little("encode_hubert")
    with timers.phase("encode_hubert"):
        enc, enc_cases = phase_encode_hubert(torch, np, card, FA, build)
    done("encode_hubert")
    flash_paths["hubert"] = enc["flash_attention_launches"]
    f32_paths["hubert"] = enc["float32_flash_launches"]
    widths["hubert_noncausal"] = enc_cases["hubert_noncausal_bfloat16"]
    widths["hubert_noncausal_float32"] = enc_cases["hubert_noncausal_float32"]

    # 33-34. training: the backward flash kernel, then smollm-135m at full
    # size through the launcher's loop
    hold_little("flash_bwd_kernel")
    with timers.phase("flash_bwd_kernel"):
        bwdk = phase_flash_bwd_kernel(torch, FA, build, card)
    for name, nums in bwdk.items():
        say("flash_bwd_kernel", case=name, **nums)
    done("flash_bwd_kernel")
    hold_little("train_smollm")
    with timers.phase("train_smollm"):
        train = phase_train_smollm(torch, card, FA)
    done("train_smollm")
    flash_paths["train_smollm"] = train["flash_attention_launches"]
    f32_paths["train_smollm"] = train["float32_flash_launches"]
    bwd_paths = {"train_smollm": train["flash_bwd_launches"]}
    bwd_f32_paths = {
        "train_smollm_float32": train["float32_flash_bwd_launches"]}
    bwd_bf16 = {k: c for k, c in bwdk.items() if "bfloat16" in c["shape"]}
    bwd_f32 = {k: c for k, c in bwdk.items() if "float32" in c["shape"]}

    # 35-38. training the scan families: the SSD and WKV backward kernels,
    # then zamba2-1.2b at full size and rwkv6-7b at full width (4 of 32
    # layers) through the launcher's loop
    hold_little("ssd_bwd_kernel")
    with timers.phase("ssd_bwd_kernel"):
        ssdb = phase_ssd_bwd_kernel(torch, SSD, card)
    for name, nums in ssdb.items():
        say("ssd_bwd_kernel", case=name, **nums)
    done("ssd_bwd_kernel")
    with timers.phase("wkv_bwd_kernel"):
        wkvb = phase_wkv_bwd_kernel(torch, R, WKV, card)
    for name, nums in wkvb.items():
        say("wkv_bwd_kernel", case=name, **nums)
    done("wkv_bwd_kernel")
    hold_little("train_zamba2")
    with timers.phase("train_zamba2"):
        tz = phase_train_zamba2(torch, card, FA, SSD)
    done("train_zamba2")
    hold_little("train_rwkv6")
    with timers.phase("train_rwkv6"):
        tr = phase_train_rwkv6(torch, card, FA, WKV)
    done("train_rwkv6")
    flash_paths["train_zamba2"] = tz["flash_launches"]
    bwd_paths["train_zamba2"] = tz["flash_bwd_launches"]

    # 39-41. qwen3-moe, dbrx and qwen2-vl trained at full width on their
    # first layer (the MoE on fewer experts) through the flash kernels at
    # GQA groups 16, 6 and 8
    for tag, arch, experts in TRAIN_FAMILIES:
        name = f"train_{tag}"
        hold_little(name)
        with timers.phase(name):
            fam = phase_train_family(torch, np, card, FA, name,
                                     train_cut(get_config(arch), experts))
        done(name)
        flash_paths[name] = fam["flash_attention_launches"]
        bwd_paths[name] = fam["flash_bwd_launches"]
        f32_paths[name] = fam["float32_flash_launches"]
        bwd_f32_paths[f"{name}_float32"] = fam["float32_flash_bwd_launches"]
    ssd_paths = {"serve_zamba2": serve["ssd_launches"],
                 "train_zamba2": tz["scan_launches"]}
    wkv_paths = {"serve_rwkv6": rserve["wkv_launches"],
                 "train_rwkv6": tr["scan_launches"]}

    def scan_bwd_entry(name, source, replaces, cases, main, path, nums):
        # ptxas's numbers only where this run compiled the library: a build
        # reused from an earlier run in this checkout has no log (null)
        log = build.build_logs.get(os.path.basename(source)[:-3])
        ptxas = ptxas_summary(log) if log else None
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": nums["scan_bwd_launches"],
            "ptxas_max_registers": None if ptxas is None else max(
                (v.get("registers", 0) for v in ptxas.values()), default=0),
            "ptxas_spill_stores": None if ptxas is None else sum(
                v.get("spill_stores", 0) for v in ptxas.values()),
            "launches_by_path": {path: nums["scan_bwd_launches"]},
            "launches_per_call": cases[main]["launches_per_call"],
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            "max_rel_err": max(c["max_rel_err"] for c in cases.values()),
            "cases": {k: {f: c[f] for f in (
                "ms", "events_ms", "plain_ms", "bound_ms", "bound_by",
                "cuda_core_bound_ms", "max_rel_err")}
                for k, c in cases.items()},
            "ms": cases[main]["ms"], "plain_ms": cases[main]["plain_ms"],
            "bound_ms": cases[main]["bound_ms"],
            "bound_by": cases[main]["bound_by"], "library_ms": None}

    # 42-43. the metric-pipeline bench and the colocation demo on the card
    with timers.phase("metric_pipeline"):
        mp = phase_metric_pipeline(torch, K, card)
    done("metric_pipeline", **mp)
    with timers.phase("colocation"):
        co = phase_colocation(torch, K, FA, card)
    done("colocation", **co)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "runqlat_hist", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/runqlat_hist.cu",
        "replaces": "src/repro/kernels/runqlat_hist.py:48",
        "launches": sum(hist_paths.values()),
        "launches_by_path": hist_paths, "max_abs_err": knums["max_abs_err"],
        "ms": knums["ms"], "plain_ms": knums["plain_ms"],
        "bound_ms": knums["bound_ms"], "bound_by": "bytes",
        "library_ms": knums["library_ms"]}, {
        "name": "rollout_tick", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rollout_tick.cu",
        "replaces": "src/repro/kernels/rollout_tick.py:85",
        "launches": sum(tick_paths.values()),
        "launches_by_path": tick_paths, "max_abs_err": fnums["max_abs_err"],
        "ms": fnums["ms"], "plain_ms": fnums["plain_ms"],
        "bound_ms": fnums["bound_ms"], "bound_by": "bytes",
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:81",
        "launches": sum(flash_paths.values()),
        "launches_by_path": flash_paths,
        "max_abs_err": max(c["max_abs_err"]
                           for c in (*flash.values(), *widths.values())),
        "width_max_abs_err": {k: c["max_abs_err"] for k, c in widths.items()},
        "sm90_widths": {k: {f: widths[k][f] for f in (
            "ms", "simt_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "bound_term")} for k in (
                "gemma3_global", "gemma3_local", "hd8_bfloat16",
                "hd16_bfloat16", "hd80_bfloat16", "hd256_bfloat16",
                "hubert_noncausal")},
        "ms": flash["main"]["ms"], "plain_ms": flash["main"]["plain_ms"],
        "bound_ms": flash["main"]["bound_ms"],
        "bound_by": flash["main"]["bound_by"],
        "library_ms": flash["main"]["library_ms"]}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
        "replaces": "src/repro/models/attention.py:181",
        "launches": sum(bwd_paths.values()),
        "launches_by_path": bwd_paths,
        "max_abs_err": max(c[f"max_abs_err_{p}"] for c in bwd_bf16.values()
                           for p in ("dq", "dk", "dv")),
        "cases": {k: {f: c[f] for f in (
            "ms", "device_ms", "simt_ms", "simt_device_ms", "plain_ms",
            "library_ms", "library_device_ms", "bound_ms", "bound_by",
            "bound_term")} for k, c in bwd_bf16.items()},
        "ms": bwdk["smollm"]["ms"], "plain_ms": bwdk["smollm"]["plain_ms"],
        "bound_ms": bwdk["smollm"]["bound_ms"],
        "bound_by": bwdk["smollm"]["bound_by"],
        "library_ms": bwdk["smollm"]["library_ms"]}, {
        "name": "flash_attention_bwd_f32", "route": "cuda",
        "source":
            "src/repro_torch/kernels/csrc/flash_attention_bwd_f32_sm90.cu",
        "replaces": "src/repro/models/attention.py:181",
        "launches": sum(bwd_f32_paths.values()),
        "launches_by_path": bwd_f32_paths,
        "max_abs_err": max(c[f"max_abs_err_{p}"] for c in bwd_f32.values()
                           for p in ("dq", "dk", "dv")),
        "cases": {k: {f: c[f] for f in (
            "ms", "device_ms", "simt_ms", "simt_device_ms", "plain_ms",
            "library_ms", "library_device_ms", "bound_ms", "bound_by",
            "bound_term", "cuda_core_bound_ms")}
            for k, c in bwd_f32.items()},
        "ms": bwdk["smollm_float32"]["ms"],
        "plain_ms": bwdk["smollm_float32"]["plain_ms"],
        "bound_ms": bwdk["smollm_float32"]["bound_ms"],
        "bound_by": bwdk["smollm_float32"]["bound_by"],
        "library_ms": bwdk["smollm_float32"]["library_ms"]}, {
        "name": "flash_attention_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_f32_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:81",
        "launches": sum(f32_paths.values()),
        "launches_by_path": f32_paths,
        "max_abs_err": max(c["max_abs_err"] for c in (
            *flash.values(), *widths.values())
            if c["kernel"] == "flash_attention_f32_sm90"),
        "widths": {k: {f: c[f] for f in (
            "ms", "simt_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "bound_term", "cuda_core_bound_ms")}
            for k, c in widths.items() if k.endswith("_float32")},
        "ms": widths["hd256_float32"]["ms"],
        "plain_ms": widths["hd256_float32"]["plain_ms"],
        "bound_ms": widths["hd256_float32"]["bound_ms"],
        "bound_by": widths["hd256_float32"]["bound_by"],
        "library_ms": widths["hd256_float32"]["library_ms"]}, {
        "name": "ssd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_sm90.cu",
        "replaces": "src/repro/kernels/ssd.py:66",
        "launches": sum(ssd_paths.values()), "launches_by_path": ssd_paths,
        "max_abs_err": max(c["max_abs_err"] for c in ssdk.values()),
        "ms": ssdk["main"]["ms"], "plain_ms": ssdk["main"]["plain_ms"],
        "bound_ms": ssdk["main"]["bound_ms"],
        "bound_by": ssdk["main"]["bound_by"], "library_ms": None}, {
        "name": "wkv", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv.cu",
        "replaces": "src/repro/kernels/rwkv_wkv.py:69",
        "launches": sum(wkv_paths.values()), "launches_by_path": wkv_paths,
        "max_abs_err": max(max(c["max_abs_err_y"], c["max_abs_err_state"])
                           for c in wkvk.values()),
        "ms": wkvk["serve_clamped"]["ms"],
        "plain_ms": wkvk["serve_clamped"]["plain_ms"],
        "bound_ms": wkvk["serve_clamped"]["bound_ms"],
        "bound_by": wkvk["serve_clamped"]["bound_by"],
        "library_ms": None},
        scan_bwd_entry("ssd_bwd",
                       "src/repro_torch/kernels/csrc/ssd_bwd_sm90.cu",
                       "src/repro/models/ssd.py:16", ssdb, "train",
                       "train_zamba2", tz),
        scan_bwd_entry("wkv_bwd", "src/repro_torch/kernels/csrc/wkv_bwd.cu",
                       "src/repro/models/rwkv.py:47", wkvb,
                       "train_clamped", "train_rwkv6", tr)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
