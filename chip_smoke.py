#!/usr/bin/env python3
"""Drive the PyTorch port (``wav2letter_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR] [--seed N]

Run from the root of a checkout on a machine with a CUDA card. Phases:

1. the device: name, count, ``nvidia-smi`` name and power limit;
2. build the CUDA kernels from ``wav2letter_tpu_torch/csrc``;
3. hold each kernel (K1 MFSC, K2 time conv, K3 residual LayerNorm, K4 fused
   attention) against its plain PyTorch version at the shapes of the serving
   paths' largest batch (fp32, and bf16 for K2-K4); K1 also at the training
   row (B=16) and at ``K1_EDGES`` (8 kHz, 40 mels, and a stride the tensor
   cores do not take, which runs K1's CUDA-core route), K3 at ``LN_EDGES``
   (D = 100, 1, 9000, R = 1, an unaligned view: its shared-memory route
   where the register route does not take them), each K1 and K3 row with
   its route, K1's with its tile and the TFLOP/s of its dense products,
   K3's with its warps a row and its library call (x + y, then
   ``F.layer_norm``) beside ``F.layer_norm`` of a precomputed sum; and the
   backward kernels
   (K2 as dgrad, K2b time-conv weight gradient, K3b residual LayerNorm
   backward, K4b attention backward) and the three autograd functions at the
   shapes of the training paths' largest batch; K4 and K4b also at T=188
   unmasked, at the gate's edge T=460, at the conformer's H=4, Dh=128,
   T=240 and at T=17 and 65, which cut K4's tiles raggedly, without dropout
   and at rate 0.2 with the same keep mask on both sides; K4b alone also at
   the long-context update (B=2, T=1712), at T=17, 65, 188 and the last T it
   takes at Dh = 192, and at Dh = 8, 64, 128, 256 (``check_attention_bwd``),
   and at the training row its time by launch; K2b and K4b twice for equal
   bits; time kernel, plain version, one PyTorch call of the same function
   where there is one, and the bound; K4 with the tile height (query rows a
   block) it picks, its blocks and its TFLOP/s; K2, its dgrad and K2b also at ``CONV_EDGES`` (C = 1 with 20
   taps, a ragged strided tile, F = 40, the largest weight the route
   admits), each row with its route (tensor cores, in bf16 or in fp32 as
   3xTF32, or CUDA cores), the schedule it launches (frames a tile, tiles a
   block, warps, blocks; fp32's split taps), TFLOP/s and share of the
   bound; times are device times with the inputs in HBM (cold L2), the
   kernel's also with L2-warm inputs; fp32 bounds count operations at
   3xTF32's 165 TFLOP/s (``PEAK_FLOPS``);
4. the main path at full width: the streaming-convnets flagship
   (``recipes/streaming_convnets/network.arch``, 80 filterbanks, 9998
   classes, 96,660,482 parameters, seeded weights) serves ~8 synthesized
   utterances of 4-15 s through the port's ``run_test`` (``Evaluator`` set-up,
   then ``evaluate``, timed apart) at batch 4, in bf16 and then fp32, with
   the launch counts of each run checked (1 K1, 15 K2, 22 K3 per batch) and
   its emissions held against the plain-version forward on the card; then
   ``PASSES`` more passes of the loaded model give the steady-state rate;
5. one profiled bf16 forward: device time by kernel;
6. training at full width: the same flagship takes ``TRAIN_UPDATES`` updates
   in bf16 (fp32 master parameters) and then in fp32 through the port's
   ``Trainer`` on 32 synthesized utterances at batch 16 (SGD momentum 0.9,
   gradient clipping, dropout and SpecAugment as the arch says, one validation
   pass and checkpoints), with the launch counts of every update checked
   (1 K1, 15 K2 + 14 dgrad, 15 K2b, 22 K3, 22 K3b), every loss finite, and
   with dropout and SpecAugment off the first batch's loss and every
   parameter's gradient held against the plain path on the card; then
   ``cli.train continue`` takes 2 more updates from ``model_last.bin``, and
   ``run_test`` serves the result; one profiled update of each type gives
   the split into forward, backward and optimizer, the idle share and the
   peak memory;
7. phases 4-6 again for the transformer (``recipes/transformer_ctc/
   network.arch`` at full width and depth, 97,670,462 parameters): served at
   batch 4 (1 K1, 12 K4, 24 K3 and no K2 per batch), trained at batch 8 (2
   bf16 and 2 fp32 updates) with adam, gradient clipping at 0.1, dropout 0.2 and layerdrop 0.1 (per update
   12 K4, 12 K4b, 24 K3, 24 K3b; the loss must fall), resumed and served;
8. the conformer (``recipes/conformer_ctc/network.arch`` at full width, 4 of
   its 16 layers): two updates and a validation pass on utterances of 4-6.3 s
   (K4 and K4b once per layer), emissions against the plain path, and a batch
   of 15 s utterances, beyond the relative-position table, that must take the
   unfused path with no K4 launch;
9. the transformer at full width, 2 of its layers, with a table of 2000
   relative positions: one bf16 update on two 134-136 s utterances (T up to
   1712 after the pools) launches K4 and K4b once per layer; serving the
   same batch takes K4;
10. the lexicon beam decode of phase 4's flagship checkpoints through
   ``cli.decode`` with ``W2L_REQUIRE_NATIVE=1`` (the native decoder built by
   ``g++`` from ``wav2letter_tpu_torch/ops/native/decoder.cpp``), a 3-gram
   ARPA of the list's transcripts and its probing ``.bin``, in bf16 and
   fp32 at batch 4, beam 100, ``--beamsizetoken=100``: the top-k-shipped
   decode (timed: audio s per wall s, the forward's device time, the beam's
   host time), the full-row decode that fills ``--emission_dir`` and the
   ``.bin`` over that cache, with the launch counts checked (1 K1, 15 K2, 22
   K3 per batch), the emissions held against the plain-version forward, the
   shipped top-k's words against the host's cut of the full rows on every
   utterance without a tie at the k-th value (tied frames, and frames whose
   top k leaves out the blank or the separator, counted), the ``.bin``'s
   words against the ARPA's, and the native beam's against the Python
   beam's on the two shortest utterances;
11. chunked streaming inference: phase 4's fp32 checkpoint through
   ``cli.convert_streaming``, the list streamed at batch 1 in 500 ms chunks
   through the Python API (``StreamingFeaturizer``, ``StreamingNetwork``)
   into the online Python beam (phase 10's lexicon and ARPA, beam 100,
   ``beamSizeToken`` 100, threshold 25, ``prune`` to 250 ms after every
   chunk), with every chunk's launches checked (1 K1 when frames come out, a
   K2 for each conv and TDS block that emits frames, two K3 for each such
   block), the streamed emissions against the batch fp32 forward on the same
   features (max 1e-4), the streamed features against the batch featurizer's
   K1 with its local CMVN in float64 (2e-3; the distance to its fp32 CMVN is
   reported), the streamed words against the same beam fed the batch emissions
   cut at the stream's chunk boundaries, ``cli.streaming_asr`` (its main,
   the shortest utterance) and ``cli.streaming_asr_multi`` (the
   4 shortest, 4 threads) against the single-stream words, and K1, K2 and
   K3 at a steady chunk's shapes against their plain versions (K2's dgrad
   and K2b there too, checked and timed though a chunk runs no backward,
   K2b twice for equal bits); the device time of a steady chunk's 15 K2
   launches replayed from one CUDA graph; the real-time factor, each
   chunk's latency (featurizer, network, beam; p50 and p95) and one
   utterance's device busy time and idle share.
12. data and tensor parallelism: two ranks on the one card, spawned and
   joined through gloo (NCCL takes one rank a device), first probe gloo's
   all-reduce, broadcast and all-gather of CUDA tensors; then the flagship at
   full width with dropout 0 and no SpecAugment (a copy of its arch) trains
   ``DP_UPDATES`` updates at 4 rows a rank against one process at 8, in fp32
   (with a validation pass and rank 0's checkpoint) and one update in bf16,
   and 1 update with ``--batching_strategy=dynamic``; the transformer's
   first 2 layers train at dp1 x mp2 (tensor parallelism: K4 and K4b on 2 of its 4 heads)
   where gloo gathers CUDA tensors; each run's launches are checked on both
   ranks, its losses and parameters held to one process (``DP_TOL``), the
   DP replicas to equal bits, the summed validation counts to one process's
   on the same weights; then one NCCL rank through ``cli.train`` with
   torchrun's variables (``--enable_distributed --world_size=1``) against
   the same one-process run. Updates/s, the gradient reduction's wall ms an
   update and its share, and the peak memory a rank are printed; gloo's are
   gloo's, not NCCL's. The same ranks run phase 21's CPC jobs on phase 13's
   corpus, which this phase makes.
13. the soak in small (``wav2letter_tpu_torch/tools/soak.py``, ``soak_path``):
   a 3-minute synthetic corpus from the port's ``synth_corpus``, its 3-gram
   LM, the flagship minus SAUG trained in bf16 at B = 16 for 20 updates in a
   child ``cli.train``, SIGKILLed once the checkpoint of update 10 is whole
   and resumed by a bare ``continue``; the soak's ``profile`` step on the
   trained run in this process (a steady update's wall, device busy, idle
   share and peak memory at the largest and median batches, one update's
   launches held to phase 6's counts, the kernels' features, loss and
   gradients against the plain versions at the largest batch in bf16 and
   fp32); then the product chain with the CLIs
   in this process (viterbi ``test``, the beam without and with the LM, the
   ``--lmweight`` sweep, the homophone slice, the beam dump and rescoring,
   ``convert_streaming``, 4 utterances streamed and split against offline,
   the top-k against the full-row decode), each step's wall time printed,
   the results' keys held to the JAX soak's (``SOAK_RESULTS.json``), the
   streamed emissions to the batch network on the same features (1e-4), and
   the chain's K1, K2 and K3 launches counted.
14. ASG at full width: ``recipes/conv_glu`` (its arch and ``train.cfg``: 40
   banks, ``--replabel=2``, ``--transdiag=4``, ``--surround=|``, sgd with
   ``--lrcrit``) on the 16 shortest utterances of phase 13's corpus: the first
   batch's ASG loss and the gradients of every leaf and of ``transitions`` on
   the card against the same model and batch on the CPU (fp32 gated:
   ``CARD_CPU_TOL``; bf16 reported), ``ASG_UPDATES`` updates in fp32 and in
   bf16 through ``cli.train`` (in fp32 one more update's wall, device busy,
   idle share, launches and peak memory), ``continue`` for 1 more
   (the transitions moved from ``transdiag·I`` and stored in equal bits);
   on the trained model's emissions the card's ``asg_loss`` and its
   gradients, ``asg_viterbi`` and ``asg_forced_align`` against the CPU's
   (``ASG_FN_TOL``); then ``cli.test``, ``cli.decode`` (native lexicon beam
   with the trained transitions and phase 13's 3-gram LM) and ``cli.align``
   on 8 test utterances, every utterance's aligned words (replabels
   unpacked) equal to its transcript; each run launches K1 and no other
   kernel (the recipe's convs are weight-normed: ``F.conv2d``);
15. the ResNet recipe at full width: ``recipes/resnet_ctc`` (80 banks, its
   ``RES``/``SKIP`` blocks) with CTC and ``--batching_strategy=dynamic`` on
   phase 13's corpus (letters, not the recipe's word pieces): the first batch
   card against CPU as in 14, ``RES_UPDATES`` updates in fp32 and bf16
   through ``cli.train``, then ``cli.test`` and ``cli.align`` (CTC forced
   alignment) under the same word-order gate; K1 alone on the card.
16, 17. the attention seq2seq recipes at full width, on phase 13's corpus
   (letters, not the recipes' word pieces; its 16 shortest training and 4
   shortest test utterances): 16 is ``recipes/seq2seq_tds`` (its ``train.cfg`` with
   ``--encoderdim=512``: a TDS encoder whose blocks normalize over time, a
   GRU decoder with keyvalue attention), 17 ``recipes/transformer_s2s`` (its
   ``train.cfg``: 12 TR layers, a 6-layer transformer decoder). Each: the
   first batch card against CPU as in 14, in fp32 only; the path's kernels at its shapes
   against their plain versions (K2, dgrad, K2b at C = 10, 14, 18; K4, K4b,
   K3, K3b at the transformer's); ``S2S_UPDATES`` updates in fp32 and bf16
   (transformer_s2s: one in bf16) through ``cli.train`` with every update's launches held to the arch (no
   K3 in seq2seq_tds), then ``continue`` (for 2 across seq2seq_tds's window
   switch, for 1 in transformer_s2s), the attention window's gate as the
   recipe sets it; on the trained model's encoder states the
   decoder's teacher-forced logits and greedy tokens card against CPU (ties
   counted), the KV-cached step against the full decoder, the native beam
   against the Python beam, one decoder step at K = 80; then ``cli.test``
   and ``cli.decode`` (native beam, the README's flags; the transformer also
   with ``--s2s_batch_decode=4``, equal to the sequential beam). ``--only
   s2s`` runs phases 1, 2, 16 and 17 alone.
18. the LM slice: the GCNN-14B ConvLM (``gcnn_lines``: Dauphin et al.'s
   ``fconv_lm_dauphin_gbw``, 161,607,984 parameters over phase 13's 150 words
   + ``</s>`` and ``<unk>``) trained by ``cli.train_lm`` in fp32 at B = 16,
   bptt 64 for ``LM_UPDATES`` updates on ~1 M tokens of phase 13's Markov
   chain (the first batch's loss and every leaf's gradient card against CPU,
   ``CARD_CPU_TOL``; the loss falls; no kernel of ours launched); the
   ConvLM's deferred scores card against CPU (``LM_ROW_TOL``); ``cli.decode
   --lmtype=convlm`` (``W2L_REQUIRE_NATIVE=1``) of 2 test utterances through
   phase 13's trained flagship (CTC, the native lexicon beam), phase 14's
   conv_glu (ASG) and phase 16's seq2seq_tds (the native seq2seq beam), each
   AM's launches counted as its phase counts them, audio s per wall s and the
   ConvLM's device calls, cache hit rate and device ms printed, and the
   native beam's words against the Python beam's on the shortest; the
   new layers (BN over 1024 channels, an LSTM, a GRU and a ReLU RNN of 512,
   2 layers, POSEMB, SINPOSEMB, PC) forward and backward card against CPU;
   ``cli.train`` 2 updates then ``continue`` 2 on ``LAYERS_ARCH`` (BN, GRU,
   POSEMB, PC) with the BN buffers reloaded in equal bits. In the full run it
   follows 16 and 17 in their child process; ``--only lm`` runs phases 1, 2
   and 18 alone, on phase 13's corpus, with the three AMs at their seeded
   weights.
19. the hooks of ``cli.train`` and ``cli.test``, first in the child process of
   16-18: the mls plugin (``recipes/mls/train_english.cfg`` with
   ``--arch=recipes/mls/mling_plugin.py``, which the loader maps to the port's
   ``plugins/mling.py``; 4 TR layers of 256, H = 4, Dh = 64; the corpus's 16
   shortest utterances, inside K4's gate after the pool) with the first batch
   card against CPU (``CARD_CPU_TOL``), K4, K4b, K3 and K3b at its shapes
   against their plain versions, 3 fp32 and 2 bf16 updates through
   ``cli.train`` (1 K1, 4 K4, 4 K4b, 8 K3, 8 K3b an update; the rows through
   K4 counted; one more update's wall, busy and idle), ``continue`` for 1
   and ``cli.test``; the flagship (B = 16, bf16, 2 updates each) plain, with
   ``--remat`` (every forward kernel but K1 launched twice), with
   ``--features_device=host`` (no K1) and with an ``--sfx_config`` chain of
   all six effects, the data threads' ms a batch and the peak memory with
   and without remat; two gloo ranks on the card against one process, one
   update each (run by phase 12's ranks in the full run): ``LAYERS_ARCH``'s
   BatchNorm at dp2, novograd at dp1 x mp2 on the flagship,
   ``recipes/conv_glu`` at full width at dp1 x mp2 (its convs split over
   their time taps and its head over its outputs, as JAX splits them).
   ``--only hooks`` runs phases 1, 2 and 19 alone.
20. the semi- and self-supervised trainers at full width, on phase 13's
   corpus and 3-gram, in a child process of their own (``--only semi`` runs
   phases 1, 2 and 20 alone): CPC (``recipes/cpc/pretrain.cfg``, its three
   archs on raw audio, B = 8): the first batch (the 4 shortest utterances)
   card against CPU in the unsupervised phase (the card's mask and negatives
   given to the CPU; ``CARD_CPU_TOL``), 2 unsupervised and 2 supervised updates through
   ``cli.train_cpc`` (each 1 K2, 1 K2b, 12 K3, 12 K3b: ``CPC_SPEC``),
   ``continue`` for 1 and a ``--pretrainmodel`` start, and K2, K2b, K3, K3b at
   its shapes against their plain versions; slimIPL
   (``recipes/slimipl/train.cfg``, the flagship at B = 16) through
   ``cli.train_slimipl`` with ``--slimIPL_start=2``, type ``cache`` and then
   ``fixed-pre-cache`` with the EMA and soft labels, each update's and each
   PL generation's launches held, and ``continue`` with the caches restored in
   equal bits; LPM (``recipes/local_prior_match/train.cfg``, ``seq2seq_tds``
   with the 80 banks and ``--encoderdim=1024`` the recipe leaves out,
   ``LPM_FIX``): one batch's proposals card against CPU,
   2 paired and 2 unpaired updates through ``cli.train_lpm`` with
   ``--propupdate=2``; IPL through ``cli.ipl`` on the flagship: a seed round
   and one round of 2 updates, its PLs from the native beam with the 3-gram,
   stopped once they are written and resumed from its state file. Each
   trainer prints one steady update's wall, device busy, idle share and peak
   memory, and its launches by kernel.
21. the tools and the flashlight reader, in a child process of their own
   (``--only tools`` runs phases 1, 2, the data and checkpoints of 4, the
   corpus of 13 and 21 alone, with a seeded flagship for 13's and its own two
   CPC ranks): (a) phase 4's fp32 flagship forged as a flashlight checkpoint
   (96,660,482 parameters) through ``cli.test`` in bf16 and fp32 (emissions
   equal in bits to the port's checkpoint's, 1 K1, 15 K2, 22 K3 a batch),
   ``cli.decode`` with phase 10's 3-gram (phase 10's words) and
   ``cli.convert_streaming`` with one utterance streamed (equal in bits to
   the stream of the port's checkpoint); (b) ``tools/prod_scale.py``'s
   200k-word lexicon and 4-gram (``PROD_LM_TOKENS``: its LM corpus cut) and
   ``cli.decode`` of phase 13's flagship on 8 test utterances with the
   probing ``.bin``, the ``.qt`` and the ARPA (the ``.bin``'s words the
   ARPA's, all in the lexicon): manifest, set-up, rate, peak host RSS; (c)
   phase 13's utterances as a LibriSpeech tree through ``data_prep`` and
   ``wordpiece`` into ``cli.train --usewordpiece=true`` on the flagship (2
   bf16 updates at B = 16, phase 6's launches each) and ``cli.test``; (d)
   CPC (``recipes/cpc``, full width, fp32, B = 4 a rank) on two gloo ranks,
   run by phase 12's ranks: one unsupervised and one supervised update and
   ``continue`` for 1, held to one process at B = 8 (``CPC_DP_TOL``), the
   replicas equal in bits, 1 K2, 1 K2b, 12 K3, 12 K3b an update a rank.

Phase 3 times the paths' rows by the profiler (cold, plain, library; K1 also
warm) and the rows off the paths (``CONV_EDGES``, ``LN_EDGES``, the
attention's edge shapes) once by CUDA events.

The kernels line holds each kernel's row of the main paths and, from phase
19, the mls plugin's K3, K3b, K4 and K4b, and from phase 20 CPC's K2, K2b, K3
and K3b.

It prints ``{"kernels": [...]}``, then the ``nvidia-smi`` line, then as the
last line ``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before that line. Without a card, or outside a checkout, it exits 2 and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
ARCH = os.path.join(REPO, "recipes", "streaming_convnets", "network.arch")
TR_ARCH = os.path.join(REPO, "recipes", "transformer_ctc", "network.arch")
CFR_ARCH = os.path.join(REPO, "recipes", "conformer_ctc", "network.arch")
N_FEAT, N_TOKENS, BATCH = 80, 9997, 4
TRAIN_UTTS = 32
TRAIN_UPDATES = {"bfloat16": 3, "float32": 2}
CONTINUE_UPDATES = 1
CFR_LAYERS = 4  # of the conformer recipe's 16
# K2 and K2b at the edges of the bf16 tensor-core route, (B, T, F, C, CO, K,
# stride, pads), beside the path's shapes: C = 1 with 20 taps (two 16-tap
# steps); stride 2 with a ragged last tile (Tout = 50); F = 40, not a
# multiple of a block's 16 positions; the largest weight the route admits
# (12 x 36 x 36, 62 KB in fp32)
CONV_EDGES = [(4, 400, 24, 1, 8, 20, 1, (10, 9)), (4, 101, 80, 16, 20, 11, 2, (8, 1)),
              (4, 300, 40, 20, 24, 11, 1, (5, 5)), (4, 300, 80, 36, 36, 12, 1, (6, 5))]
# the long-context transformer: a table of 2000 positions, T = 1712 after the pools
LONG_LAYERS, LONG_BPTT = 2, 2000
# The two model families driven at full width. ``per_forward``: launches of
# one forward (a serving or validation batch, or an update's forward);
# ``per_backward``: what an update launches on top of that. The flagship's
# first conv takes the features and has no dgrad: 14 K2 launches, not 15.
# Layerdrop scales a layer's branch by 0 and does not skip the layer, so the
# transformer's counts are fixed. The transformer trains with its recipe's
# flags, but the learning rate and warm-up (0.03 after 32000 updates) are cut
# to what a few updates can show; SpecAugment starts at update 10000 there.
# ``updates``: the spec's own depth where it is not ``TRAIN_UPDATES``.
FLAGSHIP = dict(
    name="flagship", arch=ARCH, n_params=96_660_482, flags=dict(localnrmlleftctx=300),
    per_forward={"mfsc": 1, "time_conv": 15, "residual_ln": 22},
    per_backward={"time_conv": 14, "time_conv_wgrad": 15, "residual_ln_bwd": 22},
    train=dict(batchsize=16, netoptim="sgd", lr=0.05, momentum=0.9, maxgradnorm=0.5),
    opt_slot="trace")
TRANSFORMER = dict(
    name="transformer", arch=TR_ARCH, n_params=97_670_462, flags={},
    per_forward={"mfsc": 1, "mhsa": 12, "residual_ln": 24},
    per_backward={"mhsa_bwd": 12, "residual_ln_bwd": 24},
    train=dict(batchsize=8, netoptim="adam", adambeta1=0.9, adambeta2=0.98, lr=5e-4,
               warmup=2, lr_sched="inv_sqrt", lr_step_decay=50000, maxgradnorm=0.1,
               saug_start_update=10000),
    opt_slot="mu", loss_falls=True, updates={"bfloat16": 2, "float32": 2})
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20
PASSES = 1  # steady-state passes over the served list per type
TF32_PEAK = 495e12  # H100 SXM, dense
# The least time for a function's operations, H100 SXM, dense. fp32 counts at
# the fastest fp32-accurate rate the card has: 3xTF32 on the tensor cores
# (three TF32 products a product, 495 / 3 TFLOP/s), above the CUDA cores' 67.
PEAK_FLOPS = {"float32": TF32_PEAK / 3, "bfloat16": 989e12}
TPU_KERNELS = {
    "mfsc": ("wav2letter_tpu/ops/pallas/mel.py:65", "wav2letter_tpu_torch/csrc/mfsc.cu"),
    "time_conv": ("wav2letter_tpu/ops/pallas/tconv.py:155",
                  "wav2letter_tpu_torch/csrc/tconv.cu"),
    "time_conv_wgrad": ("wav2letter_tpu/ops/pallas/tconv.py:232",
                        "wav2letter_tpu_torch/csrc/tconv_wgrad.cu"),
    "residual_ln": ("wav2letter_tpu/ops/pallas/layernorm.py:77",
                    "wav2letter_tpu_torch/csrc/layernorm.cu"),
    "residual_ln_bwd": ("wav2letter_tpu/ops/pallas/layernorm.py:111",
                        "wav2letter_tpu_torch/csrc/layernorm.cu"),
    "mhsa": ("wav2letter_tpu/ops/pallas/attention.py:236",
             "wav2letter_tpu_torch/csrc/attention.cu"),
    "mhsa_bwd": ("wav2letter_tpu/ops/pallas/attention.py:267",
                 "wav2letter_tpu_torch/csrc/attention.cu"),
}
# kernel vs plain version, |got - want| <= atol + rtol * |want|
TOL = {
    ("mfsc", "float32"): (1e-4, 1e-4),       # 400-term fp32 sums, log features
    ("time_conv", "float32"): (1e-4, 1e-4),  # <= 336-term fp32 sums
    ("time_conv", "bfloat16"): (1e-2, 1e-2),  # one bf16 rounding of the output
    ("residual_ln", "float32"): (1e-5, 1e-5),
    ("residual_ln", "bfloat16"): (2e-2, 1e-2),
    ("time_conv_dgrad", "float32"): (1e-4, 1e-4),  # <= 336-term fp32 sums
    ("time_conv_dgrad", "bfloat16"): (1e-2, 1e-2),  # one bf16 rounding of the output
    # dw sums N = B*Tout*F <= 1e6 products of O(1) values, exact in fp32 for
    # either input type, in fp32 on both sides but in another order. Entries
    # are O(sqrt N) = 1e3; the worst case of fp32 summation is
    # eps * N * E|x*dy| = 6e-8 * 1e6 * 0.64 = 0.04, and ordered blocked sums
    # stay far below it: half of that, plus 1e-4 relative
    ("time_conv_wgrad", "float32"): (1e-4, 2e-2),
    ("time_conv_wgrad", "bfloat16"): (1e-4, 2e-2),
    ("residual_ln_bwd", "float32"): (1e-5, 1e-5),
    ("residual_ln_bwd", "bfloat16"): (2e-2, 1e-2),
    # attention: fp32 sums of Dh <= 192 and T <= 460 terms in another order,
    # outputs O(0.1-1); in bf16 one rounding of the output, and of p and ds
    # where the fp32 values behind them differ in the last bit
    ("mhsa", "float32"): (1e-4, 1e-5),
    ("mhsa", "bfloat16"): (2e-2, 1e-2),
    # the gradients, each held as a share of its largest entry (``_worst``):
    # dk and dv sum T, dPwin up to B*H*T = 6144 products per entry; in bf16 p
    # and ds are rounded before their products, and the autograd of the plain
    # forward, which the function is also held against, rounds neither
    ("mhsa_bwd", "float32"): (1e-4, 1e-4),
    ("mhsa_bwd", "bfloat16"): (2e-2, 2e-2),
}
# the autograd functions against autograd of the plain forward. The two
# forwards round a few outputs of ~0 to different sides of 0 (one or two of
# 2e7 in fp32, more in bf16), so their ReLU masks differ there: one dy term
# more or less in K*C entries of dx (measured: up to 9% of the largest entry,
# in 4e-5 of the entries), in the dw of one output channel and in one dbias
# entry (0.3% of the largest). The kernels themselves are held to TOL above;
# this check is for the wiring (mask, bias, which gradient goes where), whose
# faults are of order 1. Hence an elementwise bound (rtol, atol as a share
# of the gradient's largest entry) wide enough for a few flipped terms in dw
# and dbias, and a share of entries allowed outside it for dx.
FN_TOL = {"float32": (1e-3, 2e-2, 1e-3), "bfloat16": (5e-2, 2e-2, 2e-3)}
# First training batch on the card, dropout and SpecAugment off: the kernel
# path's loss (relative) and each parameter's gradient (L2 error relative to
# the larger of that gradient's L2 norm and 1% of the whole gradient's).
# GRAD_TOL (wav2letter_tpu_torch/tools/soak.py, which checks the soak's
# batches with it): against the plain-version model on the same features.
# GRAD_TOL_FEATS: against the whole plain path, features included. K1 and its
# plain version agree to 1e-4, but local CMVN divides the first frames by the
# std of windows of 1-8 frames, which carries that rounding into the first
# layers' gradients at a few percent.
GRAD_TOL_FEATS = {"float32": (1e-4, 0.1), "bfloat16": (2e-2, 0.25)}
# emissions of the kernel path vs the plain path, full model: (max, mean) abs
EM_TOL = {"float32": (2e-3, 1e-4), "bfloat16": (0.25, 0.02)}


# GCNN-14B (Dauphin et al. 2017; fairseq's ``fconv_lm_dauphin_gbw``, which the
# reference's ``lm_librispeech_*_gcnn_14B.arch`` follow): an embedding of 128,
# a causal conv to 512, then blocks of three (width, kernel) convs, each a
# weight-normed causal ``AC`` to twice its width and ``GLU``, after a dropout,
# with a residual over the block (a projection where the width changes)
GCNN_EMB, GCNN_FIRST = 128, (512, 5)
GCNN_BLOCKS = ([((128, 1), (128, 5), (512, 1))] * 3 + [((512, 1), (512, 5), (1024, 1))] * 3
               + [((1024, 1), (1024, 5), (2048, 1))] * 6 + [((1024, 1), (1024, 5), (4096, 1))])


def gcnn_lines(vocab: int, div: int = 1, dropout: float = 0.1) -> list:
    """The GCNN-14B LM's arch lines over ``vocab`` tokens, every width
    divided by ``div`` (the CPU tests build it narrow): ids in the AF (L, B,
    1, 1) layout, ``E``, the causal convs (``WN 3 AC in 2*out k 1 -1 0``:
    all pads on the left), each block a ``RES 9 1`` of three ``DO``, conv,
    ``GLU 2`` triples with a ``SKIP`` (or a ``SKIPL`` through a 1-wide conv)
    from its input to its output scaled by sqrt(1/2), and a weight-normed
    linear head to the vocabulary."""
    w = lambda c: max(1, c // div)  # noqa: E731
    width = w(GCNN_FIRST[0])
    lines = ["V -1 0 1 1", f"E {w(GCNN_EMB)} {vocab}", "RO 1 3 0 2",
             f"WN 3 AC {w(GCNN_EMB)} {2 * width} {GCNN_FIRST[1]} 1 -1 0", "GLU 2"]
    for block in GCNN_BLOCKS:
        body, cin = [], width
        for c, k in block:
            body += [f"DO {dropout}", f"WN 3 AC {cin} {2 * w(c)} {k} 1 -1 0", "GLU 2"]
            cin = w(c)
        if cin == width:
            lines += ["RES 9 1"] + body + ["SKIP 0 10 0.7071"]
        else:
            lines += (["RES 9 1"] + body
                      + ["SKIPL 0 10 1 0.7071", f"WN 3 AC {width} {cin} 1 1 -1 0"])
        width = cin
    return lines + ["RO 2 0 3 1", f"WN 0 L {width} {vocab}"]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
def cuda_ms(fn, iters=20, warmup=3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_events(prof):
    """Kernels and copies on the card, without the profiler's own entries."""
    import torch

    for evt in prof.key_averages():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not evt.key.startswith("Activity Buffer")):
            yield evt


PROFILE_TRIES = 10


def profile_device(fn):
    """``fn()`` under the profiler, device activities only; returns the
    profiler. Now and then one comes back without any device event (seen once
    in some thousand uses, and once three in a row); such a reading is taken
    again after a pause, never kept, and each retry is logged."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        if any(True for _ in device_events(prof)):
            return prof
        log(f"[profiler] reading {attempt + 1} held no device event; taken again")
        time.sleep(0.5)
    fail(f"the profiler reported no device event {PROFILE_TRIES} times in a row")


def device_ms(fn, args, cold=True, iters=20) -> float:
    """Device time per call of ``fn(*args)``: the time of the kernels it
    launches, from the profiler, without the host's launch overhead."""
    return sum(device_split(fn, args, cold, iters).values())


def device_split(fn, args, cold=True, iters=20) -> dict:
    """``device_ms`` by kernel: {the profiler's name of a kernel: ms per call}.

    Cold (the default), the calls cycle through copies of ``args`` that
    together exceed twice the L2 cache, so each call reads its inputs from
    HBM, as the bound assumes. Warm, every call reuses the same inputs, which
    stay in L2 between calls."""
    import torch

    sets = [args]
    if cold:
        nbytes = sum(a.numel() * a.element_size() for a in args if torch.is_tensor(a))
        sets = [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                for _ in range(max(2, math.ceil(2 * L2_BYTES / nbytes)))]
        iters = max(iters, 2 * len(sets))
    fn(*args)
    torch.cuda.synchronize()

    def calls():
        for i in range(iters):
            fn(*sets[i % len(sets)])

    prof = profile_device(calls)
    return {e.key: e.self_device_time_total / 1e3 / iters for e in device_events(prof)}


# K4b's four launches, by a piece of the kernel's name
K4B_LAUNCHES = (("mhsa_bwd_rows", "rows"), ("mhsa_bwd_keys", "keys"),
                ("mhsa_bwd_pos_sum", "pos_sum"), ("mhsa_bwd_pos", "pos"))


def k4b_split(b_args) -> dict:
    """K4b's cold device time per call by launch (anything else: ``other``)."""
    from wav2letter_tpu_torch import kernels

    out = {}
    for key, ms in device_split(kernels.mhsa_bwd, b_args).items():
        name = next((n for piece, n in K4B_LAUNCHES if piece in key), "other")
        out[name] = out.get(name, 0.0) + ms
    return out


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, dtype, got, want):
    import torch

    rtol, atol = TOL[(name, dtype)]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rel = (err / want.abs().clamp(min=1e-6)).max().item()
    ok = bool(torch.all(err <= atol + rtol * want.abs())) and bool(torch.isfinite(got).all())
    return err.max().item(), rel, ok


# ---------------------------------------------------------------------------
# data, model and checkpoints
# ---------------------------------------------------------------------------
def synth_dataset(root: str, seed: int, n_utts: int = 8, name: str = "test", vocab=None,
                  dur=(4.0, 15.0)):
    """Utterances of ``dur`` seconds (4-15 s unless said): white noise loud enough that no mel band sits at
    the log floor, under a slow random envelope; ~1.5 words per second from a
    200-word lexicon spelled with 9996 word pieces plus the separator. A second
    list takes the first one's ``vocab`` (tokens and lexicon files)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    if vocab is None:
        pieces = [f"p{i:04d}" for i in range(N_TOKENS - 1)]
        words = {f"w{i:03d}": [pieces[j] for j in rng.choice(len(pieces), rng.randint(1, 4))]
                 for i in range(200)}
        tokens = os.path.join(root, "tokens.txt")
        with open(tokens, "w") as f:
            f.write("|\n" + "\n".join(pieces) + "\n")
        lexicon = os.path.join(root, "lexicon.txt")
        with open(lexicon, "w") as f:
            f.writelines(f"{w}\t{' '.join(sp)} |\n" for w, sp in words.items())
    else:
        tokens, lexicon = vocab
    lines, secs = [], 0.0
    for i in range(n_utts):
        n = int(16000 * rng.uniform(*dur))
        env = np.interp(np.arange(n), np.linspace(0, n, 20), rng.uniform(0.4, 1.0, 20))
        wav = (0.5 * env * rng.randn(n)).astype(np.float32)
        path = os.path.join(root, f"{name}{i:03d}.npy")
        np.save(path, wav)
        ws = [f"w{rng.randint(200):03d}" for _ in range(max(1, int(1.5 * n / 16000)))]
        lines.append(f"{name}{i:03d} {path} {1000.0 * n / 16000:.1f} {' '.join(ws)}")
        secs += n / 16000
    lst = os.path.join(root, f"{name}.lst")
    with open(lst, "w") as f:
        f.write("\n".join(lines) + "\n")
    return lst, tokens, lexicon, secs


def save_model(spec, root, seed, tokens, lexicon):
    """Seeded weights of ``spec``'s arch as two port checkpoints, bf16 and fp32."""
    import torch

    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.models import build_arch_module
    from wav2letter_tpu_torch.runtime.checkpoint import Checkpoint, save_checkpoint

    torch.manual_seed(seed)
    model = build_arch_module(spec["arch"], N_FEAT, N_TOKENS + 1)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != spec["n_params"]:
        fail(f"{spec['name']} has {n_params} parameters, expected {spec['n_params']}")
    paths = {}
    for dtype in ("bfloat16", "float32"):
        cfg = Config(arch=spec["arch"], tokens=tokens, lexicon=lexicon, criterion="ctc",
                     mfsc=True, filterbanks=N_FEAT, compute_dtype=dtype, batchsize=BATCH,
                     nthread=2, **spec["flags"])
        paths[dtype] = os.path.join(root, f"{spec['name']}_{dtype}.pt")
        save_checkpoint(paths[dtype], Checkpoint(cfg.serialize(), 0, 0, model.state_dict()))
    return paths, n_params


def batch_shapes(lst, tokens, lexicon, batch=BATCH):
    """(number of batches, feature frames T and audio samples S of the
    largest batch) of the batches ``run_test`` or the trainer builds from
    ``lst`` at batch size ``batch``."""
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data import AsrDataset, Lexicon, make_token_dict

    cfg = Config(arch=ARCH, tokens=tokens, lexicon=lexicon, criterion="ctc",
                 mfsc=True, filterbanks=N_FEAT, batchsize=batch)
    ds = AsrDataset(lst, make_token_dict(tokens, "ctc", 0, False),
                    Lexicon.from_file(lexicon), cfg, batch_size=batch)
    specs = ds.batch_specs()
    T = max(s.max_input_frames for s in specs)
    return len(specs), T, ds.audio_samples_for_frames(T)


def pooled_frames(T: int) -> int:
    """Frames after the transformer recipe's three stride-2 pools."""
    for _ in range(3):
        T = -(-T // 2)
    return T


def path_calls(model, B, T):
    """The K2 and K3 calls of one forward of ``model`` on (B, T, 80) features,
    walked from its layers: [(B, T, F, C, CO, K, stride, pads)], [(R, D)]."""
    from wav2letter_tpu_torch.kernels.tconv import out_frames
    from wav2letter_tpu_torch.models.layers import Conv2D, TDSBlock

    convs, lns, t = [], [], T
    for mod in model.seq.children():
        if isinstance(mod, Conv2D):
            pads = mod.pads(t)
            convs.append((B, t, N_FEAT, mod.in_ch, mod.out_ch, mod.wx, mod.sx, pads))
            t = out_frames(t, mod.wx, mod.sx, pads)
        elif isinstance(mod, TDSBlock):
            convs.append((B, t, mod.f, mod.c, mod.c, mod.w, 1, mod.time_pads))
            lns += [(B * t, mod.c * mod.f)] * 2
    return convs, lns


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
# K1 beside the paths' rows, (sample rate, mels, stride ms, B, S): 8 kHz
# with S % 4 != 0 (4-byte audio copies), 40 mels, a stride of 100 samples
# (the CUDA-core route); checked, timed warm, counted 0 times
K1_EDGES = [(8000, 40, 10.0, 4, 123457), (16000, 40, 10.0, 4, 64000),
            (16000, 80, 6.25, 4, 64000)]


def _mfsc_row(f, B, S, tag, timed=True):
    """K1 at one shape against its plain version: time, route, tile, the
    TFLOP/s of its dense products and their ceiling on the TF32 tensor
    cores, beside the function's own bound."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.kernels.mfsc import TENSOR_CORES, dense_flops, route, tile_frames

    p = f.p
    g = torch.Generator(device="cuda").manual_seed(B + S)
    pre = 0.5 * torch.randn((B, S), device="cuda", generator=g)
    frame, stride = p.frame_samples, p.stride_samples
    args = (pre, f.cos_mat, f.sin_mat, f.mel_fb, frame, stride, p.mel_floor)
    nb, nm = f.mel_fb.shape
    way = route(frame, stride, nb, nm)
    got = kernels.mfsc(*args)
    torch.cuda.synchronize()
    want = kernels.mfsc_plain(*args)
    err, rel, ok = compare("mfsc", "float32", got, want)
    T = got.shape[1]
    nbytes = 4 * (B * S + 2 * frame * nb + nb * nm + B * T * nm)
    # the operations the function needs per frame, not the dense products
    # the kernel does: a real FFT of n_fft points (2.5 N log2 N), the
    # magnitude of each bin, a multiply-add per nonzero of the triangular
    # filterbank, and the log of each mel
    n_fft = p.n_fft
    nnz = int((f.mel_fb != 0).sum())
    flops = B * T * (2.5 * n_fft * math.log2(n_fft) + 4 * nb + 2 * nnz + nm)
    b_ms, b_by = bound(nbytes, flops, "float32")
    dense = dense_flops(B, T, frame, nb, nm)
    if timed:
        ms, warm = device_ms(kernels.mfsc, args), device_ms(kernels.mfsc, args, cold=False)
        plain = device_ms(kernels.mfsc_plain, args)
    else:
        ms = warm = cuda_ms(lambda: kernels.mfsc(*args))
        plain = None
    row = dict(name="mfsc", dtype="float32", shape=[B, S, T], tag=tag, max_abs_err=err,
               max_rel_err=rel, tol=TOL[("mfsc", "float32")], ok=ok, ms=ms, warm_ms=warm,
               plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by,
               calls=1 if timed else 0, route=way,
               tile=tile_frames(B, T, torch.cuda.get_device_properties(0).multi_processor_count)
               if way == TENSOR_CORES else 32,
               frame=frame, stride=stride, n_mels=nm, dense_gflop=dense / 1e9,
               dense_tflops=dense / ms / 1e9, dense_ceiling_ms=dense / TF32_PEAK * 1e3)
    log(f"[K1] {tag} {[B, S, T]} frame {frame} stride {stride} mels {nm}: {way}, tile "
        f"{row['tile']}, {ms:.4f} ms cold, {warm:.4f} warm; dense products "
        f"{row['dense_tflops']:.1f} TFLOP/s (ceiling {row['dense_ceiling_ms']:.4f} ms at the "
        f"TF32 peak); function bound {b_ms:.4f} ms ({b_by}); max err {err:.2e}")
    return row


def check_mfsc(B, S, details, tag="serve"):
    """K1 at a path's row, on the route it takes."""
    from wav2letter_tpu_torch.features import FeatureParams, Featurizer

    f = Featurizer(FeatureParams(n_filterbanks=N_FEAT)).cuda()
    row = _mfsc_row(f, B, S, tag)
    details.append(row)
    return [row]


def check_mfsc_edges(details):
    """K1 at ``K1_EDGES``, each on the route it takes."""
    from wav2letter_tpu_torch.features import FeatureParams, Featurizer

    for rate, mels, stride_ms, B, S in K1_EDGES:
        f = Featurizer(FeatureParams(sample_rate=rate, n_filterbanks=mels,
                                     frame_stride_ms=stride_ms)).cuda()
        row = _mfsc_row(f, B, S, f"edge_{rate}_{mels}_{f.p.stride_samples}", timed=False)
        row["edge"] = True
        details.append(row)


def _conv_log(row, tag):
    """One line per K2, dgrad or K2b row: route, schedule, time, TFLOP/s, bound
    share."""
    log(f"[{tag}] {row['name']} {row['dtype']} {row['shape']} calls={row['calls']}: "
        f"{row['route']} {json.dumps(row['schedule'])}, {row['ms']:.4f} ms (library "
        f"{row['library_ms']}), {row['tflops']:.1f} TFLOP/s, "
        f"{row['bound_ms'] / row['ms']:.3f} of the bound")


def _conv_layout(dtype, key, kind, Tout):
    """The route of one K2 (``kind`` "conv" or "dgrad") or K2b ("wgrad") call
    at ``key`` and, on the tensor cores, the schedule it launches."""
    import torch

    from wav2letter_tpu_torch.kernels.tconv import route, schedule

    B, T, Fq, C, CO, K, s = key[:7]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    frames = T if kind == "dgrad" else Tout
    return dict(route=route(dtype, C, CO, K, s, Fq, kind),
                schedule=schedule(dtype, B, frames, C, CO, K, s, Fq, sms, kind))


def check_time_conv(convs, dtype_name, details, edges=(), time_plain=True):
    """K2 at every conv shape of one forward, and at ``edges`` (not on the
    path: timed, counted 0 times); the plain version timed too where
    ``time_plain``."""
    import torch
    import torch.nn.functional as F

    from wav2letter_tpu_torch import kernels

    dtype = getattr(torch, dtype_name)
    rows = []
    for key in sorted(set(convs), key=convs.index) + list(edges):
        B, T, Fq, C, CO, K, s, pads = key
        g = torch.Generator(device="cuda").manual_seed(T + K)
        x = torch.randn((B, T, Fq * C), device="cuda", generator=g).to(dtype)
        w = (0.1 * torch.randn((K, C, CO), device="cuda", generator=g)).to(dtype)
        bias = torch.randn((CO,), device="cuda", generator=g)
        args = (x, w, Fq, s, pads, bias, True)
        got = kernels.time_conv(*args)
        torch.cuda.synchronize()
        err, rel, ok = compare("time_conv", dtype_name, got, kernels.time_conv_plain(*args))
        # one PyTorch call of the same conv: conv2d on the NCHW layout, with
        # the time pads and the layout change done before the timing
        edge = key in edges
        xn = F.pad(x.view(B, T, Fq, C).permute(0, 3, 2, 1), pads).contiguous()
        wn = w.permute(2, 1, 0).unsqueeze(2).contiguous()
        bn = bias.to(dtype)
        Tout = got.shape[1]
        item = x.element_size()
        nbytes = item * (x.numel() + w.numel() + got.numel()) + 4 * CO
        flops = 2 * B * Tout * Fq * CO * K * C
        b_ms, b_by = bound(nbytes, flops, dtype_name)
        if edge:  # off the path: timed once, warm, by events
            ms = warm = cuda_ms(lambda: kernels.time_conv(*args))
            lib_ms = plain = None
        else:
            lib_ms = device_ms(lambda a, b_, c: F.conv2d(a, b_, c, stride=(1, s)), (xn, wn, bn))
            ms, warm = device_ms(kernels.time_conv, args), None
            plain = device_ms(kernels.time_conv_plain, args) if time_plain else None
        row = dict(name="time_conv", dtype=dtype_name, shape=list(key[:7]) + [list(pads)],
                   max_abs_err=err, max_rel_err=rel, tol=TOL[("time_conv", dtype_name)],
                   ok=ok, ms=ms, warm_ms=warm, plain_ms=plain,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                   calls=convs.count(key), tflops=flops / ms / 1e9, edge=edge,
                   **_conv_layout(dtype, key, "conv", Tout))
        _conv_log(row, "K2")
        rows.append(row)
        details.append(row)
    return [r for r in rows if not r["edge"]]


def _ln_log(row):
    log(f"[K3] {row['dtype']} {row['shape']} calls={row['calls']}: {row['route']}"
        + (f", {row['warps_per_row']} warps a row" if row["route"] == "registers" else "")
        + f", {row['ms']:.4f} ms cold; x + y and F.layer_norm "
        f"{row['library_ms']}, F.layer_norm of the sum {row.get('layer_norm_ms')}; bound "
        f"{row['bound_ms']:.4f} ({row['bound_by']})")


def _ln_inputs(R, D, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((R, D), device="cuda", generator=g).to(dtype)
    y = torch.randn((R, D), device="cuda", generator=g).to(dtype)
    return x, y, torch.tensor([1.3], device="cuda"), torch.tensor([-0.2], device="cuda")


def _ln_compare(dtype_name, got, want):
    import torch

    err, rel, ok = compare("residual_ln", dtype_name, got[0], want[0])
    ok = ok and torch.allclose(got[1], want[1], rtol=1e-5, atol=1e-5) \
        and torch.allclose(got[2], want[2], rtol=1e-5, atol=1e-5)
    return err, rel, bool(ok)


def _ln_layout(x):
    from wav2letter_tpu_torch.kernels.layernorm import REGISTERS, route, warps_per_row

    D = x.shape[1]
    way = route(D, x.element_size(), x.data_ptr() % 16 == 0)
    return dict(route=way, warps_per_row=warps_per_row(D, x.element_size())
                if way == REGISTERS else 0)


def check_residual_ln(lns, dtype_name, details):
    """K3 at every row shape of one forward, on the route it takes. Its
    library call is K3's own function unfused: x + y, then ``F.layer_norm``
    (two launches); ``F.layer_norm`` of a precomputed sum, which reads one
    tensor where K3 reads two, stands beside it as ``layer_norm_ms``."""
    import torch
    import torch.nn.functional as F

    from wav2letter_tpu_torch import kernels

    dtype = getattr(torch, dtype_name)
    rows = []
    for key in sorted(set(lns), key=lns.index):
        R, D = key
        x, y, w, b = _ln_inputs(R, D, dtype, R + D)
        got = kernels.residual_ln(x, y, w, b)
        torch.cuda.synchronize()
        want = kernels.residual_ln_plain(x, y, w, b)
        err, rel, ok = _ln_compare(dtype_name, got, want)
        wd, bd = w.to(dtype).expand(D).contiguous(), b.to(dtype).expand(D).contiguous()
        lib_ms = device_ms(lambda a, a2, c, d: F.layer_norm(a + a2, (D,), c, d, 1e-5),
                           (x, y, wd, bd))
        ln_ms = device_ms(lambda a, c, d: F.layer_norm(a, (D,), c, d, 1e-5), (x + y, wd, bd))
        item = x.element_size()
        nbytes = 3 * R * D * item + 8 * R + 8
        flops = 8 * R * D
        b_ms, b_by = bound(nbytes, flops, "float32")  # statistics in fp32
        args = (x, y, w, b)
        row = dict(name="residual_ln", dtype=dtype_name, shape=[R, D], max_abs_err=err,
                   max_rel_err=rel, tol=TOL[("residual_ln", dtype_name)], ok=ok,
                   ms=device_ms(kernels.residual_ln, args),
                   warm_ms=None,
                   plain_ms=device_ms(kernels.residual_ln_plain, args),
                   library_ms=lib_ms, layer_norm_ms=ln_ms, bound_ms=b_ms, bound_by=b_by,
                   calls=lns.count(key), **_ln_layout(x))
        _ln_log(row)
        rows.append(row)
        details.append(row)
    return rows


# K3 beside the paths' rows, (R, D): D not a multiple of 8 (bf16 through
# shared memory), D = 1, D past the register route (8192 bf16, 4096 fp32),
# R = 1, and a view one element past an aligned start (through shared
# memory); checked, timed warm, counted 0 times
LN_EDGES = [(256, 100), (256, 1), (64, 9000), (1, 1280), ("unaligned", 1280)]


def check_residual_ln_edges(dtype_name, details):
    import torch

    from wav2letter_tpu_torch import kernels

    dtype = getattr(torch, dtype_name)
    for R, D in LN_EDGES:
        if R == "unaligned":
            R = 50
            x, y, w, b = _ln_inputs(R * D + 1, 1, dtype, D)
            x = x.view(-1)[1:].view(R, D)
            y = y.view(-1)[1:].view(R, D)
        else:
            x, y, w, b = _ln_inputs(R, D, dtype, R + D)
        got = kernels.residual_ln(x, y, w, b)
        torch.cuda.synchronize()
        err, rel, ok = _ln_compare(dtype_name, got, kernels.residual_ln_plain(x, y, w, b))
        ms = cuda_ms(lambda: kernels.residual_ln(x, y, w, b))
        b_ms, b_by = bound(3 * R * D * x.element_size() + 8 * R + 8, 8 * R * D, "float32")
        row = dict(name="residual_ln", dtype=dtype_name, shape=[R, D], max_abs_err=err,
                   max_rel_err=rel, tol=TOL[("residual_ln", dtype_name)], ok=ok, ms=ms,
                   warm_ms=ms, plain_ms=None, library_ms=None, layer_norm_ms=None,
                   bound_ms=b_ms, bound_by=b_by, calls=0, edge=True,
                   aligned=x.data_ptr() % 16 == 0, **_ln_layout(x))
        _ln_log(row)
        details.append(row)


def _conv_inputs(key, dtype):
    """x, w, bias and dy of one K2 call, seeded by its shape."""
    import torch

    from wav2letter_tpu_torch.kernels.tconv import out_frames

    B, T, Fq, C, CO, K, s, pads = key
    g = torch.Generator(device="cuda").manual_seed(T + K + C)
    x = torch.randn((B, T, Fq * C), device="cuda", generator=g).to(dtype)
    w = (0.1 * torch.randn((K, C, CO), device="cuda", generator=g)).to(dtype)
    bias = torch.randn((CO,), device="cuda", generator=g)
    Tout = out_frames(T, K, s, pads)
    dy = torch.randn((B, Tout, Fq * CO), device="cuda", generator=g).to(dtype)
    return x, w, bias, dy


def _function_errors(got, want, dtype_name):
    """Share of entries of each gradient outside the elementwise bound of
    ``FN_TOL``, and the largest error as a share of the largest entry."""
    rtol, ashare, _ = FN_TOL[dtype_name]
    out = []
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        err = (g - w).abs()
        top = w.abs().max().clamp(min=1e-30)
        outside = (err > ashare * top + rtol * w.abs()).float().mean().item()
        out.append((outside, (err.max() / top).item()))
    return out


def check_time_conv_backward(convs, dtype_name, details, edges=(), time_plain=True):
    """K2 as dgrad, K2b, and the autograd function (with bias and ReLU) at
    every conv shape of one training forward, and at ``edges`` (counted 0
    times); K2b twice for equal bits; the plain versions timed too where
    ``time_plain``."""
    import torch
    import torch.nn.functional as F

    from wav2letter_tpu_torch import kernels

    dtype = getattr(torch, dtype_name)
    rows = {"time_conv_dgrad": [], "time_conv_wgrad": []}
    for n, key in enumerate(sorted(set(convs), key=convs.index) + list(edges)):
        B, T, Fq, C, CO, K, s, pads = key
        edge = key in edges
        x, w, bias, dy = _conv_inputs(key, dtype)
        Tout, item = dy.shape[1], x.element_size()
        flops = 2 * B * Tout * Fq * CO * K * C  # the products the data needs
        shape = list(key[:7]) + [list(pads)]
        # the library's calls on the stored NCHW layout, pads and layout
        # changes done before the timing
        xn = F.pad(x.view(B, T, Fq, C).permute(0, 3, 2, 1), pads).contiguous()
        dyn = dy.view(B, Tout, Fq, CO).permute(0, 3, 2, 1).contiguous()
        wn = w.permute(2, 1, 0).unsqueeze(2).contiguous()

        # dgrad; the first conv of the model takes the features and has none
        if n > 0:
            args = (dy, w, Fq, T, s, pads)
            got = kernels.time_conv_dgrad(*args)
            torch.cuda.synchronize()
            err, rel, ok = compare("time_conv_dgrad", dtype_name, got,
                                   kernels.time_conv_dgrad_plain(*args))
            b_ms, b_by = bound(item * (dy.numel() + w.numel() + x.numel()), flops, dtype_name)
            if edge:  # off the path: timed once, warm, by events
                ms = warm = cuda_ms(lambda: kernels.time_conv_dgrad(*args))
                lib_ms = plain = None
            else:
                lib_ms = device_ms(
                    lambda a, b_: torch.nn.grad.conv2d_input(xn.shape, b_, a, stride=(1, s)),
                    (dyn, wn))
                ms, warm = device_ms(kernels.time_conv_dgrad, args), None
                plain = device_ms(kernels.time_conv_dgrad_plain, args) if time_plain else None
            rows["time_conv_dgrad"].append(dict(
                name="time_conv_dgrad", dtype=dtype_name, shape=shape, max_abs_err=err,
                max_rel_err=rel, tol=TOL[("time_conv_dgrad", dtype_name)], ok=ok,
                ms=ms, warm_ms=warm, plain_ms=plain,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, calls=convs.count(key),
                tflops=flops / ms / 1e9, edge=edge,
                **_conv_layout(dtype, key, "dgrad", Tout)))
            _conv_log(rows["time_conv_dgrad"][-1], "K2 dgrad")

        args = (x, dy, K, Fq, s, pads)
        got = kernels.time_conv_wgrad(*args)
        torch.cuda.synchronize()
        err, rel, ok = compare("time_conv_wgrad", dtype_name, got,
                               kernels.time_conv_wgrad_plain(*args))
        ok = ok and torch.equal(got, kernels.time_conv_wgrad(*args))  # ordered sums
        b_ms, b_by = bound(item * (x.numel() + dy.numel()) + 4 * K * C * CO, flops, dtype_name)
        if edge:  # off the path: timed once, warm, by events
            ms = warm = cuda_ms(lambda: kernels.time_conv_wgrad(*args))
            lib_ms = plain = None
        else:
            lib_ms = device_ms(
                lambda a, b_: torch.nn.grad.conv2d_weight(a, wn.shape, b_, stride=(1, s)),
                (xn, dyn))
            ms, warm = device_ms(kernels.time_conv_wgrad, args), None
            plain = device_ms(kernels.time_conv_wgrad_plain, args) if time_plain else None
        row = dict(
            name="time_conv_wgrad", dtype=dtype_name, shape=shape, max_abs_err=err,
            max_rel_err=rel, tol=TOL[("time_conv_wgrad", dtype_name)], ok=bool(ok),
            ms=ms, warm_ms=warm, plain_ms=plain,
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, calls=convs.count(key),
            tflops=flops / ms / 1e9, edge=edge, **_conv_layout(dtype, key, "wgrad", Tout))
        _conv_log(row, "K2b")

        # the whole function against autograd of the plain forward
        grads = {}
        for side, fn in (("kernel", kernels.time_conv), ("plain", kernels.time_conv_plain)):
            leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
            out = fn(leaves[0], leaves[1], Fq, s, pads, leaves[2], True)
            grads[side] = torch.autograd.grad(out, leaves, dy)
        errs = _function_errors(grads["kernel"], grads["plain"], dtype_name)
        row["function_outside_share"] = [e[0] for e in errs]  # dx, dw, dbias
        row["function_max_err_share"] = [e[1] for e in errs]
        row["ok"] = row["ok"] and all(e[0] <= FN_TOL[dtype_name][2] for e in errs)
        rows["time_conv_wgrad"].append(row)
    for v in rows.values():
        details.extend(v)
    return {k: [r for r in v if not r["edge"]] for k, v in rows.items()}


def check_residual_ln_bwd(lns, dtype_name, details):
    import torch
    import torch.nn.functional as F

    from wav2letter_tpu_torch import kernels

    dtype = getattr(torch, dtype_name)
    rows = []
    for key in sorted(set(lns), key=lns.index):
        R, D = key
        g = torch.Generator(device="cuda").manual_seed(R + D + 1)
        x, y, dout = (torch.randn((R, D), device="cuda", generator=g).to(dtype)
                      for _ in range(3))
        w = torch.tensor([1.3], device="cuda")
        b = torch.tensor([-0.2], device="cuda")
        _, mu, rsig = kernels.residual_ln(x, y, w, b)
        args = (dout, x, y, mu, rsig, w)
        dz, row_g, row_gz = kernels.residual_ln_bwd(*args)
        torch.cuda.synchronize()
        want = kernels.residual_ln_bwd_plain(*args)
        err, rel, ok = compare("residual_ln_bwd", dtype_name, dz, want[0])
        # fp32 row sums of <= 2240 O(1) terms
        ok = ok and torch.allclose(row_g, want[1], rtol=1e-4, atol=1e-3) \
            and torch.allclose(row_gz, want[2], rtol=1e-4, atol=1e-3)
        # the library's call: autograd of layer_norm on a precomputed x + y
        z = (x + y).requires_grad_(True)
        wd = w.to(dtype).expand(D).contiguous().requires_grad_(True)
        bd = b.to(dtype).expand(D).contiguous().requires_grad_(True)
        ln_out = F.layer_norm(z, (D,), wd, bd, 1e-5)
        lib_ms = device_ms(
            lambda a: torch.autograd.grad(ln_out, (z, wd, bd), a, retain_graph=True), (dout,))
        item = x.element_size()
        b_ms, b_by = bound(4 * R * D * item + 16 * R + 4, 12 * R * D, "float32")
        row = dict(name="residual_ln_bwd", dtype=dtype_name, shape=[R, D], max_abs_err=err,
                   max_rel_err=rel, tol=TOL[("residual_ln_bwd", dtype_name)],
                   ms=device_ms(kernels.residual_ln_bwd, args),
                   warm_ms=None,
                   plain_ms=device_ms(kernels.residual_ln_bwd_plain, args),
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, calls=lns.count(key))
        # the whole function against autograd of the plain forward
        grads = {}
        for side, fn in (("kernel", kernels.residual_ln), ("plain", kernels.residual_ln_plain)):
            leaves = [t.clone().requires_grad_(True) for t in (x, y, w, b)]
            grads[side] = torch.autograd.grad(fn(*leaves)[0], leaves, dout)
        errs = _function_errors(grads["kernel"][:2], grads["plain"][:2], dtype_name)
        # dw, db: fp32 sums over R*D <= 3e7 terms of O(1) on both sides, in
        # another order; held as a share of their spread sqrt(R*D)
        scalar_tol = 1e-3 if dtype_name == "float32" else 2e-2
        scale = math.sqrt(R * D)
        scalars = [abs(float(a) - float(c)) / scale
                   for a, c in zip(grads["kernel"][2:], grads["plain"][2:])]
        row["function_outside_share"] = [e[0] for e in errs]  # dx, dy
        row["function_scalar_err"] = scalars  # dw, db over sqrt(R*D)
        row["ok"] = bool(ok) and all(e[0] <= FN_TOL[dtype_name][2] for e in errs) \
            and all(e <= scalar_tol for e in scalars)
        rows.append(row)
        details.append(row)
    return rows


def _attention_inputs(B, T, H, Dh, masked, dtype):
    """q (scaled as the model scales it), k, v, g (B, T, H*Dh), the window of
    the relative-position table and a ragged key mask, seeded by the shape."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(B * 1000 + T + Dh)
    q, k, v, dout = (0.5 * torch.randn((B, T, H * Dh), device="cuda", generator=g)
                     for _ in range(4))
    pos = 0.1 * torch.randn((2 * T - 1, Dh), device="cuda", generator=g)
    mask = torch.zeros((B, T), device="cuda")
    if masked:  # the first row full, the others 50-100% valid
        lens = torch.randint(T // 2, T + 1, (B,), device="cuda", generator=g)
        lens[0] = T
        mask = (torch.arange(T, device="cuda")[None] >= lens[:, None]).float() * -1e30
    return tuple(t.to(dtype) for t in (q, k, v, pos)) + (mask, dout.to(dtype))


def _worst(name, dtype_name, got, want):
    """Several outputs against their references: the largest absolute error,
    the largest error as a share of its output's largest entry, and whether
    every entry is within ``rtol * |want| + atol * max(1, max |want|)``: the
    gradients are sums of up to 1e5 terms whose size grows with the shape, so
    the absolute part scales with the output."""
    import torch

    rtol, atol = TOL[(name, dtype_name)]
    worst, share, ok = 0.0, 0.0, True
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        top = max(1.0, b.abs().max().item())
        worst, share = max(worst, err.max().item()), max(share, err.max().item() / top)
        ok = ok and bool(torch.all(err <= atol * top + rtol * b.abs())) \
            and bool(torch.isfinite(a).all())
    return worst, share, ok


def check_attention(shapes, dtype_name, details):
    """K4, K4b and the autograd function against their plain versions at
    every shape of ``shapes`` [(tag, B, T, H, Dh, masked, calls)], without
    dropout and at rate 0.2 (the same seed on both sides: the same keep mask);
    K4b twice for equal bits. Times at the rate the path runs the shape with:
    0 for the serving shape's forward, 0.1 for the mls plugin's (tag ``mls``,
    whose K4 and K4b are both timed by the profiler), 0.2 for the rest. The
    library's call is
    ``scaled_dot_product_attention`` on pre-split heads with the relative-
    position bias and the key mask passed as ``attn_mask``, and its autograd
    for q, k, v (it has no gradient for the table)."""
    import torch
    import torch.nn.functional as F

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.kernels import attention
    from wav2letter_tpu_torch.kernels.attention import mhsa_flops

    dtype = getattr(torch, dtype_name)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {"mhsa": [], "mhsa_bwd": []}
    for tag, B, T, H, Dh, masked, calls in shapes:
        q, k, v, pos, mask, dout = _attention_inputs(B, T, H, Dh, masked, dtype)
        errs = {"mhsa": [0.0, 0.0, True], "mhsa_bwd": [0.0, 0.0, True]}

        def note(name, res):
            e = errs[name]
            errs[name] = [max(e[0], res[0]), max(e[1], res[1]), e[2] and bool(res[2])]

        for rate in (0.0, 0.2):
            seed = 1000 + T
            got = kernels.mhsa(q, k, v, pos, mask, H, rate, seed)
            torch.cuda.synchronize()
            note("mhsa", compare("mhsa", dtype_name, got,
                                 kernels.mhsa_plain(q, k, v, pos, mask, H, rate, seed)))
            back = kernels.mhsa_bwd(q, k, v, pos, mask, dout, H, rate, seed)
            torch.cuda.synchronize()
            want = kernels.mhsa_bwd_plain(q, k, v, pos, mask, dout, H, rate, seed)
            note("mhsa_bwd", _worst("mhsa_bwd", dtype_name, back, want))
            again = kernels.mhsa_bwd(q, k, v, pos, mask, dout, H, rate, seed)
            same = all(torch.equal(a, b) for a, b in zip(back, again))  # ordered sums
            # the function: K4 + K4b under autograd against autograd of the plain forward
            grads = {}
            for side, fn in (("kernel", kernels.mhsa), ("plain", kernels.mhsa_plain)):
                leaves = [t.clone().requires_grad_(True) for t in (q, k, v, pos)]
                out = fn(*leaves, mask, H, rate, seed)
                grads[side] = torch.autograd.grad(out, leaves, dout)
            res = _worst("mhsa_bwd", dtype_name, grads["kernel"], grads["plain"])
            note("mhsa_bwd", (res[0], res[1], res[2] and same))
            del got, back, want, again, grads

        rate_f = {"serve": 0.0, "mls": 0.1}.get(tag, 0.2)
        rate_b = 0.1 if tag == "mls" else 0.2
        # the paths' rows are timed by the profiler (cold, plain, library): K4
        # at the serving row, K4b at the training row, both at the mls row;
        # the others once by events
        timed_fwd, timed = tag in ("serve", "mls"), tag in ("train", "mls")
        item = q.element_size()
        qh, kh, vh = (t.view(B, T, H, Dh).transpose(1, 2).contiguous() for t in (q, k, v))
        ar = torch.arange(T, device="cuda")
        idx = (ar[None, :] - ar[:, None] + T - 1).expand(B, H, T, T)
        bias = torch.einsum("bhtd,rd->bhtr", qh.float(), pos.float()).gather(-1, idx)
        bias = (bias + mask[:, None, None, :]).to(dtype).contiguous()

        def sdpa(a, b_, c, m, rate=rate_f):
            return F.scaled_dot_product_attention(a, b_, c, attn_mask=m, dropout_p=rate,
                                                  scale=1.0)

        f_args = (q, k, v, pos, mask, H, rate_f, 7)
        nbytes = item * (4 * q.numel() + pos.numel()) + 4 * mask.numel()
        b_ms, b_by = bound(nbytes, mhsa_flops(B, T, H, Dh), dtype_name)
        e = errs["mhsa"]
        # K4's tile: the query rows a block it picks, and each height that fits, timed
        tile = attention.fwd_tile_rows(B, H, T, Dh, item, sms)
        if timed_fwd:
            ms = device_ms(kernels.mhsa, f_args)
            warm = None
            plain = device_ms(kernels.mhsa_plain, f_args)
            lib = device_ms(sdpa, (qh, kh, vh, bias))
        else:
            ms, warm, plain, lib = cuda_ms(lambda: kernels.mhsa(*f_args)), None, None, None
        rows["mhsa"].append(dict(
            name="mhsa", tag=tag, dtype=dtype_name, shape=[B, T, H, Dh], rate=rate_f,
            max_abs_err=e[0], max_rel_err=e[1], tol=TOL[("mhsa", dtype_name)], ok=e[2],
            ms=ms, warm_ms=warm, plain_ms=plain, library_ms=lib,
            bound_ms=b_ms, bound_by=b_by, calls=calls, tile_rows=tile,
            blocks=-(-T // tile) * H * B, tflops=mhsa_flops(B, T, H, Dh) / ms / 1e9))
        log(f"[K4] {tag} {dtype_name} B={B} T={T} H={H} Dh={Dh}: {tile} rows a block, "
            f"{rows['mhsa'][-1]['blocks']} blocks, {ms:.4f} ms, "
            f"{rows['mhsa'][-1]['tflops']:.1f} TFLOP/s")

        b_args = (q, k, v, pos, mask, dout, H, rate_b, 7)
        leaves = [t.requires_grad_(True) for t in (qh, kh, vh)]
        lib_out = sdpa(*leaves, bias, rate_b)
        gh = dout.view(B, T, H, Dh).transpose(1, 2).contiguous()
        nbytes = item * (7 * q.numel() + pos.numel()) + 4 * (mask.numel() + pos.numel())
        b_ms, b_by = bound(nbytes, mhsa_flops(B, T, H, Dh, backward=True), dtype_name)
        e = errs["mhsa_bwd"]
        split = k4b_split(b_args) if timed else {}
        rows["mhsa_bwd"].append(dict(
            name="mhsa_bwd", tag=tag, dtype=dtype_name, shape=[B, T, H, Dh], rate=rate_b,
            max_abs_err=e[0], max_rel_err=e[1], tol=TOL[("mhsa_bwd", dtype_name)], ok=e[2],
            ms=sum(split.values()) if timed else cuda_ms(lambda: kernels.mhsa_bwd(*b_args)),
            split_ms=split,
            warm_ms=None,
            plain_ms=device_ms(kernels.mhsa_bwd_plain, b_args) if timed else None,
            library_ms=device_ms(
                lambda a: torch.autograd.grad(lib_out, leaves, a, retain_graph=True), (gh,))
            if timed else None,
            bound_ms=b_ms, bound_by=b_by, calls=calls,
            tile_rows=attention.fwd_tile_rows(B, H, T, Dh, item, sms, attention.BWD_ROWS)))
        r = rows["mhsa_bwd"][-1]
        log(f"[K4b] {tag} {dtype_name} B={B} T={T} H={H} Dh={Dh}: {r['ms']:.4f} ms by launch "
            f"{json.dumps({k: round(v, 4) for k, v in split.items()})}; autograd of SDPA "
            f"{r['library_ms']} ms; {mhsa_flops(B, T, H, Dh, True) / r['ms'] / 1e9:.1f} "
            "TFLOP/s")
        del lib_out, leaves, bias, idx
        torch.cuda.empty_cache()
    for v_ in rows.values():
        details.extend(v_)
    return rows


def check_attention_bwd(shapes, dtype_name, details):
    """K4b alone against its plain version at shapes [(tag, B, T, H, Dh)]
    beyond the paths' (the long-context transformer's update, ragged T, the
    last T it takes, the head widths), masked, without dropout and at rate
    0.2; twice for equal bits; its time at rate 0.2 from CUDA events, warm
    (``ms``), which spares the profiler."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.kernels.attention import mhsa_flops, mhsa_takes

    dtype = getattr(torch, dtype_name)
    out = []
    for tag, B, T, H, Dh in shapes:
        if not mhsa_takes(B, T, H, Dh, dtype, backward=True):
            fail(f"K4b {tag}: mhsa_takes refuses B={B} T={T} H={H} Dh={Dh} {dtype_name}")
        q, k, v, pos, mask, dout = _attention_inputs(B, T, H, Dh, True, dtype)
        err = [0.0, 0.0, True]
        for rate in (0.0, 0.2):
            args = (q, k, v, pos, mask, dout, H, rate, 1000 + T)
            got = kernels.mhsa_bwd(*args)
            torch.cuda.synchronize()
            res = _worst("mhsa_bwd", dtype_name, got, kernels.mhsa_bwd_plain(*args))
            same = all(torch.equal(a, b) for a, b in zip(got, kernels.mhsa_bwd(*args)))
            err = [max(err[0], res[0]), max(err[1], res[1]), err[2] and res[2] and same]
            del got
            torch.cuda.empty_cache()
        ms = cuda_ms(lambda: kernels.mhsa_bwd(q, k, v, pos, mask, dout, H, 0.2, 7))
        item = q.element_size()
        nbytes = item * (7 * q.numel() + pos.numel()) + 4 * (mask.numel() + pos.numel())
        b_ms, b_by = bound(nbytes, mhsa_flops(B, T, H, Dh, backward=True), dtype_name)
        out.append(dict(name="mhsa_bwd", tag=tag, dtype=dtype_name, shape=[B, T, H, Dh],
                        rate=0.2, max_abs_err=err[0], max_rel_err=err[1],
                        tol=TOL[("mhsa_bwd", dtype_name)], ok=err[2], ms=ms, timing="events",
                        bound_ms=b_ms, bound_by=b_by, calls=0,
                        tflops=mhsa_flops(B, T, H, Dh, True) / ms / 1e9))
        log(f"[K4b] {tag} {dtype_name} B={B} T={T} H={H} Dh={Dh}: {ms:.4f} ms, "
            f"{out[-1]['tflops']:.1f} TFLOP/s, error share {err[1]:.2e}, ok {err[2]}")
        del q, k, v, pos, mask, dout
        torch.cuda.empty_cache()
    details.extend(out)
    return out


def k4b_edges(dtype_name):
    """The shapes of ``check_attention_bwd``: the long-context update, T that
    cut the tiles raggedly, the last T K4b takes at Dh = 192, head widths."""
    last = 2728 if dtype_name == "bfloat16" else 2648
    return [("long_context", 2, 1712, 4, 192), ("edge_T17", 2, 17, 4, 192),
            ("edge_T65", 2, 65, 4, 192), ("edge_T188", 2, 188, 4, 192),
            ("edge_limit", 1, last, 4, 192), ("edge_Dh8", 2, 150, 4, 8),
            ("edge_Dh64", 2, 150, 4, 64), ("edge_Dh128", 2, 150, 4, 128),
            ("edge_Dh256", 2, 150, 2, 256)]


def per_forward(rows):
    """Sum a kernel's rows over one forward, weighting each shape by its calls."""
    out = {k: 0.0 for k in ("ms", "plain_ms", "bound_ms")}
    lib = 0.0 if all(r["library_ms"] is not None for r in rows) else None
    for r in rows:
        for k in out:
            out[k] += r[k] * r["calls"]
        if lib is not None:
            lib += r["library_ms"] * r["calls"]
    ops = sum(r["calls"] for r in rows if r["bound_by"] == "operations")
    out["bound_by"] = "operations" if ops * 2 > sum(r["calls"] for r in rows) else "bytes"
    out["library_ms"] = lib
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def plain_path_emissions(am, lst):
    """Per-utterance emissions of the plain-version forward on the card, on
    the batches ``run_test`` builds; also the forward times of both paths."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data import AsrDataset
    from wav2letter_tpu_torch.features import FeatureParams, Featurizer
    from wav2letter_tpu_torch.models import build_arch_module
    from wav2letter_tpu_torch.runtime.test import Evaluator

    ev = Evaluator(Config(am=am, test=lst, batchsize=BATCH), device="cuda")
    feat = Featurizer(FeatureParams.from_config(ev.cfg), ops=kernels.PLAIN).cuda()
    model = build_arch_module(ev.cfg.arch, N_FEAT, ev.n_classes, ops=kernels.PLAIN)
    model.load_state_dict(ev.model.state_dict())
    model.cuda().eval()
    ds = AsrDataset(ev.cfg.test, ev.token_dict, ev.lexicon, ev.cfg,
                    batch_size=ev.cfg.batchsize)
    out, times = {}, {"kernel_ms": [], "plain_ms": []}
    for spec in ds.batch_specs():
        batch = ds.materialize(spec)
        audio = torch.from_numpy(batch["audio"]).cuda()
        alen = torch.from_numpy(batch["audio_len"]).cuda()

        def plain():
            with torch.no_grad():
                f, fl = feat(audio, alen)
                return model(f.to(ev.dtype), fl)

        em, elen = plain()
        for i, idx in enumerate(batch["sample_idx"]):
            out[ds.samples[int(idx)].sample_id] = em[i, : int(elen[i])].float()
        times["kernel_ms"].append(cuda_ms(lambda: ev.emissions(batch), iters=5, warmup=1))
        times["plain_ms"].append(cuda_ms(plain, iters=5, warmup=1))
    return out, times, ev, ds


def main_path(spec, paths, lst, secs, emdir, n_batches):
    import numpy as np
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.runtime.test import Evaluator, evaluate

    results, evaluators = {}, {}
    # the first run pays for CUDA library set-up; it is checked, not kept
    for run, dtype_name in enumerate(("bfloat16", "bfloat16", "float32")):
        em_dir = os.path.join(emdir, spec["name"], dtype_name)
        # --batchsize is an evaluation flag: as in the JAX package, the command
        # line's value (default 1) replaces the checkpoint's
        cfg = Config(am=paths[dtype_name], test=lst, emission_dir=em_dir, batchsize=BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        # run_test(cfg) in its two parts: set-up (checkpoint load, model build,
        # copy to the card), then one pass over the list
        t0 = time.perf_counter()
        ev = Evaluator(cfg, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = evaluate(ev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        want = expected_launches(spec, 0, n_batches)
        if launches != want:
            fail(f"{spec['name']} {dtype_name} main path launches {launches}, expected {want}")
        if run == 0:
            log(f"[main {spec['name']} warm-up {dtype_name}] {t2 - t0:.3f} s, "
                f"launches {launches}")
            continue
        # steady state: more passes of the loaded model over the same list,
        # without the optional emission dumps
        ev.cfg.update({"emission_dir": ""})
        t3 = time.perf_counter()
        for _ in range(PASSES):
            evaluate(ev)
        torch.cuda.synchronize()
        pass_s = (time.perf_counter() - t3) / PASSES
        ref, times, ev, ds = plain_path_emissions(paths[dtype_name], lst)
        evaluators[dtype_name] = (ev, ds)
        errs, n_frames = [], 0
        for sid, want_em in ref.items():
            got = torch.from_numpy(np.load(os.path.join(em_dir, f"{sid}.npz"))["emission"])
            got = got.cuda()
            if got.shape != want_em.shape or got.shape[1] != N_TOKENS + 1:
                fail(f"{dtype_name} {sid}: emissions {tuple(got.shape)} vs "
                     f"{tuple(want_em.shape)}")
            if not torch.isfinite(got).all():
                fail(f"{dtype_name} {sid}: non-finite emissions")
            errs.append((got - want_em).abs())
            n_frames += got.shape[0]
        err = torch.cat([e.flatten() for e in errs])
        max_err, mean_err = err.max().item(), err.mean().item()
        tol = EM_TOL[dtype_name]
        ok = max_err <= tol[0] and mean_err <= tol[1]
        results[dtype_name] = dict(
            utterances=len(ref), audio_s=secs, setup_s=t1 - t0, first_pass_s=t2 - t1,
            steady_pass_s=pass_s, steady_passes=PASSES, steady_x_real_time=secs / pass_s,
            TER=res["TER"], WER=res["WER"],
            loss=res["loss"], peak_mem_gib=peak / 2**30, launches=launches,
            em_frames=n_frames, em_max_abs_err=max_err, em_mean_abs_err=mean_err,
            em_tol=tol, forward_kernel_ms=times["kernel_ms"],
            forward_plain_ms=times["plain_ms"], ok=ok)
        log(f"[main {spec['name']} {dtype_name}] {json.dumps(results[dtype_name])}")
        if not ok:
            fail(f"{spec['name']} {dtype_name} emissions differ from the plain path: max {max_err} mean "
                 f"{mean_err} (tolerance {tol})")
    return (results, *evaluators["bfloat16"])


def profile_forward(ev, ds):
    """Device time by kernel over one bf16 forward of the largest batch."""
    import torch

    spec = max(ds.batch_specs(), key=lambda s: s.max_input_frames)
    batch = ds.materialize(spec)
    ev.emissions(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev.emissions(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3  # without the profiler's overhead
    prof = profile_device(lambda: ev.emissions(batch))
    rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                   for e in device_events(prof)), reverse=True)
    busy = sum(r[0] for r in rows)
    return dict(dtype=str(ev.dtype), batch=[len(spec.indices), spec.max_input_frames],
                wall_ms=wall_ms, device_busy_ms=busy, idle_share=1 - busy / wall_ms,
                top=[dict(ms=round(ms, 4), kernel=k[:90], count=c) for ms, k, c in rows[:14]])


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------
def train_flags(spec, lst, valid_lst, tokens, lexicon, rundir, dtype_name, n_updates):
    return dict(
        train=lst, valid=f"dev:{valid_lst}", tokens=tokens, lexicon=lexicon, rundir=rundir,
        runname=f"{spec['name']}_{dtype_name}", arch=spec["arch"], criterion="ctc", mfsc=True,
        filterbanks=N_FEAT, compute_dtype=dtype_name, validbatchsize=BATCH, nthread=2,
        onorm="target", sqnorm=True, iter=n_updates, reportiters=n_updates, seed=0,
        **spec["flags"], **spec["train"])


def expected_launches(spec, updates, valid_batches):
    """Launches of ``updates`` updates and ``valid_batches`` validation or
    serving forwards, as ``spec``'s arch implies them (flagship: per update 1
    K1, 15 K2 forward + 14 as dgrad, 15 K2b, 22 K3, 22 K3b; transformer: 1 K1,
    12 K4, 12 K4b, 24 K3, 24 K3b). Viterbi launches no kernel of ours."""
    from wav2letter_tpu_torch.kernels import LAUNCHES

    return {k: spec["per_forward"].get(k, 0) * (updates + valid_batches)
            + spec["per_backward"].get(k, 0) * updates for k in LAUNCHES}


def first_batch_gradients(spec, cfg_flags, dtype_name):
    """Loss and parameter gradients of the first training batch with dropout
    and SpecAugment off (the modules in eval mode, autograd on), same weights:
    the kernel path against the plain-version model on the same features (K1's),
    and against the whole plain path, features included."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data.batching import pad_batch_rows
    from wav2letter_tpu_torch.features import FeatureParams, Featurizer
    from wav2letter_tpu_torch.models import build_arch_module
    from wav2letter_tpu_torch.runtime.train import Trainer
    from wav2letter_tpu_torch.tools.soak import GRAD_TOL

    cfg = Config()
    cfg.update(dict(cfg_flags, rundir="", runname=""))
    tr = Trainer(cfg, device="cuda")
    first = tr.train_ds.batch_specs(shuffle_seed=cfg.seed + 1)[0]
    batch = tr._to_device(pad_batch_rows(tr.train_ds.materialize(first), 1))
    plain = build_arch_module(spec["arch"], N_FEAT, tr.n_classes, ops=kernels.PLAIN)
    plain.load_state_dict(tr.model.state_dict())
    plain.cuda()
    with torch.no_grad():
        k1_feats = tr.featurizer(batch["audio"], batch["audio_len"])
    sides = {
        "kernel": (tr.model, tr.featurizer),
        "plain_model": (plain, lambda audio, audio_len: k1_feats),
        "plain_path": (plain, Featurizer(FeatureParams.from_config(cfg),
                                         ops=kernels.PLAIN).cuda()),
    }
    out = {}
    for side, (tr.model, tr.featurizer) in sides.items():
        tr.model.eval()
        for p in tr.model.parameters():
            p.grad = None
        kernels.reset_launches()
        loss, _, _ = tr._loss(batch, train=False)
        loss.backward()
        torch.cuda.synchronize()
        out[side] = (loss.item(), {k: p.grad for k, p in tr.model.named_parameters()},
                     dict(kernels.LAUNCHES))
    kl, kg, klaunch = out["kernel"]
    want = expected_launches(spec, 1, 0)
    if klaunch != want or any(out["plain_path"][2].values()):
        fail(f"{spec['name']} {dtype_name} first-batch launches {klaunch} (kernel path), "
             f"{out['plain_path'][2]} (plain path), expected {want} and none")
    # (a bias on the keys shifts every score of a row alike: softmax does not
    # see it and its gradient is rounding, possibly exactly 0)
    zero = [k for k, g in kg.items()
            if g is None or not torch.isfinite(g).all()
            or not (g.abs().max() > 0 or k.endswith("attn.wk.bias"))]
    if zero:
        fail(f"{dtype_name}: parameters without a finite, non-zero gradient: {zero}")
    res = dict(loss_kernel=kl, n_params=len(kg), launches=klaunch, ok=math.isfinite(kl))
    for side, tols in (("plain_model", GRAD_TOL), ("plain_path", GRAD_TOL_FEATS)):
        pl, pg, _ = out[side]
        # A leaf's error is held against its own norm, but not against less
        # than 1% of the whole gradient's: the LayerNorm biases inside a TDS
        # block are followed by another LayerNorm, which takes a constant shift
        # out again, so their true gradient is ~0 and what is left is rounding
        # of either path.
        total = torch.sqrt(sum(g.float().pow(2).sum() for g in pg.values())).item()
        diff = torch.sqrt(sum((kg[k] - pg[k]).float().pow(2).sum() for k in pg)).item()
        leaves = sorted(((kg[k] - g).norm().item() / max(g.norm().item(), 0.01 * total), k)
                        for k, g in pg.items())[::-1]
        loss_tol, grad_tol = tols[dtype_name]
        cmp = dict(loss=pl, loss_rel_err=abs(kl - pl) / abs(pl), grad_norm=total,
                   grad_rel_l2=diff / total,
                   worst_leaves=[dict(name=k, rel_l2=r) for r, k in leaves[:3]],
                   tol=[loss_tol, grad_tol])
        cmp["ok"] = bool(cmp["loss_rel_err"] <= loss_tol and leaves[0][0] <= grad_tol)
        res[side] = cmp
        res["ok"] = res["ok"] and cmp["ok"]
    log(f"[train grads {spec['name']} {dtype_name}] {json.dumps(res)}")
    if not res["ok"]:
        fail(f"{spec['name']} {dtype_name} first-batch loss or gradients differ from the plain path")
    return res


class _ProfiledPhase:
    """Wraps a phase of ``Trainer.train_step`` in a profiler of its own and
    adds the device time of the kernels it saw to ``busy[name]``."""

    def __init__(self, phase, name, busy):
        from torch.profiler import ProfilerActivity, profile

        self.phase, self.name, self.busy = phase, name, busy
        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        self.phase.__enter__()

    def __exit__(self, *exc):
        self.phase.__exit__(*exc)  # drains the device: the trainer's timers are synced
        self.prof.__exit__(*exc)
        ms = sum(e.self_device_time_total for e in device_events(self.prof)) / 1e3
        self.busy[self.name] = self.busy.get(self.name, 0.0) + ms


def profile_update(tr, batch):
    """More updates of a trained ``Trainer`` on ``batch`` at learning rate 0:
    one with the device drained at the phase boundaries, for the split by phase
    (host clock around drained work, and device time of each phase's kernels
    from one profiler per phase); one free-running for the wall time; one
    free-running under the profiler for device busy time, idle share and the
    kernels by device time."""
    import torch

    args = (batch, 0.0, 0.0, False, 12345)
    tr.train_step(*args)
    tr.meters.reset_train()
    busy, timed = {}, tr._timed
    tr._timed = lambda timer, name: _ProfiledPhase(timed(timer, name), name[4:], busy)
    tr.sync_timers = True
    tr.train_step(*args)
    tr.sync_timers = False
    tr._timed = timed
    m = tr.meters
    host = {"forward": m.fwd_timer.avg_ms(), "criterion": m.crit_fwd_timer.avg_ms(),
            "backward": m.bwd_timer.avg_ms(), "optimizer": m.optim_timer.avg_ms()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train_step(*args)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = profile_device(lambda: tr.train_step(*args))
    rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                   for e in device_events(prof)), reverse=True)
    total = sum(r[0] for r in rows)
    return dict(dtype=str(tr.compute_dtype), batch=list(batch["audio"].shape),
                drained_ms_by_phase=host, device_ms_by_phase=busy, wall_ms=wall_ms,
                device_busy_ms=total, idle_share=1 - total / wall_ms,
                top=[dict(ms=round(ms, 4), kernel=k[:90], count=c) for ms, k, c in rows[:16]])


def training_path(spec, tmp, train_lst, serve_lst, tokens, lexicon, valid_batches):
    """The trainer at full width on ``spec``'s arch, bf16 then fp32;
    ``continue``; ``run_test``."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.cli.train import main as train_main
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data.batching import pad_batch_rows
    from wav2letter_tpu_torch.runtime.checkpoint import load_checkpoint
    from wav2letter_tpu_torch.runtime.test import run_test
    from wav2letter_tpu_torch.runtime.train import Trainer

    rundir = os.path.join(tmp, "runs")
    results = {}
    for dtype_name, n_updates in spec.get("updates", TRAIN_UPDATES).items():
        flags = train_flags(spec, train_lst, serve_lst, tokens, lexicon, rundir, dtype_name,
                            n_updates)
        runname = flags["runname"]
        grads = first_batch_gradients(spec, flags, dtype_name)
        cfg = Config()
        cfg.update(flags)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = Trainer(cfg, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        steps, step = [], tr.train_step

        def timed_step(batch, *a):
            # launches of this update alone; the time between the ends of two
            # updates is one whole iteration (data, update, viterbi, meters)
            before = dict(kernels.LAUNCHES)
            res = step(batch, *a)
            torch.cuda.synchronize()
            steps.append(dict(
                end=time.perf_counter(), loss=res[0], finite=res[1],
                audio_s=float(batch["audio_len"].sum()) / 16000,
                frames=int(batch["audio"].shape[1]),
                launches={k: v - before[k] for k, v in kernels.LAUNCHES.items()}))
            return res

        tr.train_step = timed_step
        kernels.reset_launches()
        tr.run()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        want = expected_launches(spec, n_updates, valid_batches)
        if launches != want:
            fail(f"{runname} training launches {launches}, expected {want}")
        per_update = expected_launches(spec, 1, 0)
        bad = [s for s in steps if s["launches"] != per_update or not s["finite"]
               or not math.isfinite(s["loss"])]
        if len(steps) != n_updates or bad:
            fail(f"{runname} training: {len(steps)} updates, faulty: {bad[:2]}")
        # (not gated for the flagship, whose SAUG line blanks nearly every cell)
        if spec.get("loss_falls") and not steps[-1]["loss"] < steps[0]["loss"]:
            fail(f"{runname}: the loss did not fall: {[s['loss'] for s in steps]}")
        last = os.path.join(rundir, runname, "model_last.bin")
        ckpt = load_checkpoint(last)
        if ckpt.updates != n_updates or not ckpt.opt_state["state"][spec["opt_slot"]]:
            fail(f"{runname}: model_last.bin holds update {ckpt.updates}")
        span = steps[-1]["end"] - steps[0]["end"]  # steady state: after the first update
        steady_audio = sum(s["audio_s"] for s in steps[1:])
        res = dict(
            updates=n_updates, batch=spec["train"]["batchsize"], setup_s=setup_s,
            losses=[s["loss"] for s in steps], frames=[s["frames"] for s in steps],
            iteration_s=[b["end"] - a["end"] for a, b in zip(steps, steps[1:])],
            updates_per_s=(n_updates - 1) / span, audio_s_per_s=steady_audio / span,
            s_per_update=span / (n_updates - 1), peak_mem_gib=peak / 2**30,
            launches=launches, launches_per_update=per_update, first_batch=grads)
        tr.train_step = step
        if dtype_name == "bfloat16":  # the split of an update, in the type served at scale
            largest = max(tr.train_ds.batch_specs(), key=lambda s: s.max_input_frames)
            res["profile"] = profile_update(
                tr, pad_batch_rows(tr.train_ds.materialize(largest), 1))
        results[dtype_name] = res
        log(f"[train {runname}] {json.dumps(res)}")
        del tr
        torch.cuda.empty_cache()

    # continue: 2 more bf16 updates from model_last.bin, through the command line's main
    n0 = spec.get("updates", TRAIN_UPDATES)["bfloat16"]
    kernels.reset_launches()
    runname = f"{spec['name']}_bfloat16"
    tr = train_main(["continue", f"--rundir={rundir}", f"--runname={runname}",
                     f"--iter={n0 + CONTINUE_UPDATES}", f"--reportiters={n0 + CONTINUE_UPDATES}"])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    want = expected_launches(spec, CONTINUE_UPDATES, valid_batches)
    last = os.path.join(rundir, runname, "model_last.bin")
    ckpt = load_checkpoint(last)
    if (tr.updates, ckpt.updates, tr.run_idx) != (n0 + CONTINUE_UPDATES,) * 2 + (2,) \
            or launches != want or tr.skipped:
        fail(f"continue ended at update {tr.updates} (checkpoint {ckpt.updates}, run index "
             f"{tr.run_idx}, skipped {tr.skipped}), launches {launches}, expected {want}")
    del tr
    torch.cuda.empty_cache()

    # slice 1's test binary serves the trained checkpoint
    kernels.reset_launches()
    served = run_test(Config(am=last, test=serve_lst, batchsize=BATCH), device="cuda")
    launches = dict(kernels.LAUNCHES)
    want = expected_launches(spec, 0, valid_batches)
    if launches != want or not math.isfinite(served["loss"]):
        fail(f"run_test on the trained checkpoint: {served}, launches {launches}")
    results["continue"] = dict(updates=ckpt.updates, launches=launches)
    results["served"] = served
    log(f"[train {spec['name']} continue+serve] updates {ckpt.updates}, served {json.dumps(served)}")
    return results


# ---------------------------------------------------------------------------
# the conformer: a short phase at full width
# ---------------------------------------------------------------------------
def conformer_path(tmp, tokens, lexicon, seed):
    """``recipes/conformer_ctc`` at full width and ``CFR_LAYERS`` of its 16
    layers. 8 utterances of 4-6.3 s (batches are padded to a multiple of 128
    feature frames, so at most 640, which the stride-3 conv takes to 214,
    within the arch's 240 relative positions): two bf16 updates and a
    validation pass through ``Trainer`` with K4 and K4b launched once per
    layer, then emissions of the kernel path against the plain path. A batch
    of 15 s utterances (500 frames) is beyond the table: attention takes the
    unfused PyTorch path, K4 is launched no time, and both paths agree."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data import AsrDataset
    from wav2letter_tpu_torch.data.batching import pad_batch_rows
    from wav2letter_tpu_torch.models import build_arch_module
    from wav2letter_tpu_torch.runtime.train import Trainer

    with open(CFR_ARCH) as f:
        lines = [l for l in f.read().splitlines() if l.strip() and not l.startswith("#")]
    layers = [l for l in lines if l.startswith("CFR")]
    arch = os.path.join(tmp, "conformer_cut.arch")
    with open(arch, "w") as f:
        f.write("\n".join([l for l in lines if not l.startswith("CFR")][:-1]
                          + layers[:CFR_LAYERS] + [lines[-1]]) + "\n")
    root = os.path.join(tmp, "data")
    lst, _, _, secs = synth_dataset(root, seed + 2, 8, "cfr", (tokens, lexicon), (4.0, 6.3))
    long_lst, _, _, _ = synth_dataset(root, seed + 3, 4, "cfrlong", (tokens, lexicon),
                                      (14.9, 15.0))
    spec = dict(name="conformer", arch=arch, flags={},
                per_forward={"mfsc": 1, "mhsa": CFR_LAYERS},
                per_backward={"mhsa_bwd": CFR_LAYERS},
                train=dict(batchsize=8, netoptim="adam", lr=5e-4, warmup=2,
                           lr_sched="inv_sqrt", lr_step_decay=20000, maxgradnorm=0.5))
    cfg = Config()
    cfg.update(train_flags(spec, lst, lst, tokens, lexicon, os.path.join(tmp, "runs"),
                           "bfloat16", 2))
    tr = Trainer(cfg, device="cuda")
    n_params = sum(p.numel() for p in tr.model.parameters())
    losses, step = [], tr.train_step

    def recording(*a):
        res = step(*a)
        losses.append(res[0])
        return res

    tr.train_step = recording
    kernels.reset_launches()
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = expected_launches(spec, 2, 2)  # 8 utterances validate as 2 batches of 4
    if launches != want or len(losses) != 2 or not all(math.isfinite(x) for x in losses):
        fail(f"conformer: launches {launches}, expected {want}; losses {losses}")

    plain = build_arch_module(arch, N_FEAT, tr.n_classes, ops=kernels.PLAIN)
    plain.load_state_dict(tr.model.state_dict())
    plain.cuda().eval()
    tr.model.eval()
    out = {}
    for name, path, fused in (("short", lst, True), ("long", long_lst, False)):
        cfg_l = Config()
        cfg_l.update(dict(cfg.asdict(), train=path, batchsize=4))
        ds = AsrDataset(path, tr.token_dict, tr.lexicon, cfg_l, batch_size=4)
        spec_b = max(ds.batch_specs(), key=lambda b: b.max_input_frames)
        b = tr._to_device(pad_batch_rows(ds.materialize(spec_b), 1))
        res = {}
        for dtype in (torch.bfloat16, torch.float32):
            with torch.no_grad():
                feats, flen = tr.featurizer(b["audio"], b["audio_len"])
                kernels.reset_launches()
                got, glen = tr.model(feats.to(dtype), flen)
                n_k4 = kernels.LAUNCHES["mhsa"]
                ref, _ = plain(feats.to(dtype), flen)
            torch.cuda.synchronize()
            if n_k4 != (CFR_LAYERS if fused else 0):
                fail(f"conformer {name}: {n_k4} K4 launches at {got.shape[1]} frames")
            err = (got.float() - ref.float()).abs()
            dt = str(dtype).split(".")[1]
            tol = EM_TOL[dt]
            res[dt] = dict(frames=int(got.shape[1]), k4_launches=n_k4,
                           em_max_abs_err=err.max().item(), em_mean_abs_err=err.mean().item(),
                           tol=tol)
            if not (torch.isfinite(got).all() and err.max().item() <= tol[0]
                    and err.mean().item() <= tol[1]):
                fail(f"conformer {name} {dt}: emissions differ from the plain path: {res[dt]}")
        out[name] = res
    result = dict(layers=CFR_LAYERS, n_params=n_params, audio_s=secs, losses=losses,
                  run_s=run_s, launches=launches, **out)
    log(f"[conformer] {json.dumps(result)}")
    return result


def long_context_path(tmp, tokens, lexicon, seed):
    """``recipes/transformer_ctc`` at full width, ``LONG_LAYERS`` of its 12
    layers, with a relative-position table of ``LONG_BPTT`` frames: two
    utterances of 134-136 s give T = 1680-1712 after the pools, inside the
    table and inside K4b's limit (K4's: T <= 2728 in bf16 at Dh = 192). One
    bf16 update through ``Trainer`` launches K4 and K4b once per layer, its
    validation pass K4 once per layer; emissions of the kernel path against
    the plain path."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data import AsrDataset
    from wav2letter_tpu_torch.data.batching import pad_batch_rows
    from wav2letter_tpu_torch.models import build_arch_module
    from wav2letter_tpu_torch.runtime.train import Trainer

    with open(TR_ARCH) as f:
        lines = [l for l in f.read().splitlines() if l.strip() and not l.startswith("#")]
    layers = [l.split() for l in lines if l.startswith("TR")][:LONG_LAYERS]
    for fields in layers:
        fields[4] = str(LONG_BPTT)
    arch = os.path.join(tmp, "transformer_long.arch")
    with open(arch, "w") as f:
        f.write("\n".join([l for l in lines if not l.startswith("TR")][:-1]
                          + [" ".join(x) for x in layers] + [lines[-1]]) + "\n")
    root = os.path.join(tmp, "data")
    lst, _, _, secs = synth_dataset(root, seed + 4, 2, "long", (tokens, lexicon), (134.0, 136.0))
    spec = dict(name="long_context", arch=arch, flags={},
                per_forward={"mfsc": 1, "mhsa": LONG_LAYERS, "residual_ln": 2 * LONG_LAYERS},
                per_backward={"mhsa_bwd": LONG_LAYERS, "residual_ln_bwd": 2 * LONG_LAYERS},
                train=dict(batchsize=2, netoptim="adam", lr=5e-4, warmup=2,
                           lr_sched="inv_sqrt", lr_step_decay=20000, maxgradnorm=0.1))
    cfg = Config()
    cfg.update(train_flags(spec, lst, lst, tokens, lexicon, os.path.join(tmp, "runs"),
                           "bfloat16", 1))
    tr = Trainer(cfg, device="cuda")
    losses, step = [], tr.train_step

    def recording(*a):
        res = step(*a)
        losses.append(res[0])
        return res

    tr.train_step = recording
    kernels.reset_launches()
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = expected_launches(spec, 1, 1)
    if launches != want or len(losses) != 1 or not math.isfinite(losses[0]):
        fail(f"long context: launches {launches}, expected {want}; losses {losses}")

    plain = build_arch_module(arch, N_FEAT, tr.n_classes, ops=kernels.PLAIN)
    plain.load_state_dict(tr.model.state_dict())
    plain.cuda().eval()
    tr.model.eval()
    cfg_l = Config()
    cfg_l.update(dict(cfg.asdict(), batchsize=2))
    ds = AsrDataset(lst, tr.token_dict, tr.lexicon, cfg_l, batch_size=2)
    b = tr._to_device(pad_batch_rows(ds.materialize(ds.batch_specs()[0]), 1))
    with torch.no_grad():
        feats, flen = tr.featurizer(b["audio"], b["audio_len"])
        kernels.reset_launches()
        got, _ = tr.model(feats.to(torch.bfloat16), flen)
        n_k4 = kernels.LAUNCHES["mhsa"]
        ref, _ = plain(feats.to(torch.bfloat16), flen)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    tol = EM_TOL["bfloat16"]
    result = dict(layers=LONG_LAYERS, bptt=LONG_BPTT, audio_s=secs, frames=int(got.shape[1]),
                  loss=losses[0], run_s=run_s, launches=launches, serve_k4_launches=n_k4,
                  em_max_abs_err=err.max().item(), em_mean_abs_err=err.mean().item(), tol=tol)
    log(f"[long context] {json.dumps(result)}")
    if not (torch.isfinite(got).all() and n_k4 == LONG_LAYERS and got.shape[1] >= 1680
            and err.max().item() <= tol[0] and err.mean().item() <= tol[1]):
        fail(f"long context: serving at T >= 1680 through K4: {result}")
    return result



# ---------------------------------------------------------------------------
# phase 10: the lexicon beam decode
# ---------------------------------------------------------------------------
DECODE_K = 100  # --beamsizetoken: the top-k the producer ships of 9998 classes
DECODE_FLAGS = [f"--batchsize={BATCH}", "--beamsize=100", f"--beamsizetoken={DECODE_K}",
                "--beamthreshold=25", "--lmweight=1", "--wordscore=0.5", "--smearing=max",
                "--nthread_decoder=2"]
PY_BEAM = 20  # the Python beam's width on the two shortest utterances


def read_hyps(sclite_dir, lst):
    """{sample id: hypothesis words} of a decode's sclite ``.hyp``."""
    with open(os.path.join(sclite_dir, os.path.basename(lst) + ".hyp")) as f:
        rows = [l.rsplit(" (", 1) for l in f.read().splitlines()]
    return {sid.rstrip(")"): words.split() for words, sid in rows}


def decode_path(paths, lst, secs, tmp, n_batches, smi_line):
    """The flagship through ``cli.decode`` (``W2L_REQUIRE_NATIVE=1``) with a
    3-gram ARPA of the list's transcripts, per type: (A) the top-k-shipped
    decode, timed; (B) the full-row decode that fills ``--emission_dir``;
    (C) the probing ``.bin`` of the LM over that cache. Checks the launches of
    A and B (1 K1, 15 K2, 22 K3 per batch, none in C), the decoder's class,
    B's emissions against the plain-version forward, C's words against B's,
    A's words against the decode of B's rows cut to their top k on the host
    on every utterance without a tie at the k-th value, and the native beam's
    words against the Python beam's on the two shortest utterances."""
    import numpy as np
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.cli.decode import main as decode_main
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.decoder.native import NativeBeamDecoder
    from wav2letter_tpu_torch.runtime.decode import build_decoder, result_to_words, sparse_rows
    from wav2letter_tpu_torch.tools.ngram_lm import build_binary, train_ngram_lm

    t_phase = time.perf_counter()
    os.environ["W2L_REQUIRE_NATIVE"] = "1"
    root = os.path.join(tmp, "decode")
    os.makedirs(root, exist_ok=True)
    corpus = os.path.join(root, "corpus.txt")
    with open(lst) as f, open(corpus, "w") as out:
        out.writelines(" ".join(line.split()[3:]) + "\n" for line in f)
    arpa = os.path.join(root, "lm.arpa")
    t0 = time.perf_counter()
    train_ngram_lm(corpus, arpa, order=3)
    lm_bin = build_binary(arpa, os.path.join(root, "lm.bin"))  # builds decoder.cpp
    prep_s = time.perf_counter() - t0
    serve = expected_launches(FLAGSHIP, 0, n_batches)
    results = {}
    for dt in ("bfloat16", "float32"):
        d = os.path.join(root, dt)
        em_dir = os.path.join(d, "em")
        base = [f"--am={paths[dt]}", f"--test={lst}", *DECODE_FLAGS]
        runs = {}
        for name, extra, want in (
                ("topk", [f"--lm={arpa}"], serve),
                ("full", [f"--lm={arpa}", f"--emission_dir={em_dir}"], serve),
                ("bin", [f"--lm={lm_bin}", f"--emission_dir={em_dir}"],
                 {k: 0 for k in serve})):
            torch.cuda.synchronize()
            kernels.reset_launches()
            res = decode_main(base + extra + [f"--sclite={os.path.join(d, name)}"])
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            if launches != want:
                fail(f"decode {dt} {name}: launches {launches}, expected {want}")
            if res["decoder"] != "NativeBeamDecoder":
                fail(f"decode {dt} {name}: the beam ran on {res['decoder']}")
            runs[name] = dict(res, launches=launches,
                              hyps=read_hyps(os.path.join(d, name), lst))
        if runs["bin"]["hyps"] != runs["full"]["hyps"]:
            fail(f"decode {dt}: the .bin LM decodes otherwise than the ARPA")
        # B's emissions against the plain-version forward on the card
        ref, _, ev, ds = plain_path_emissions(paths[dt], lst)
        ems, err_max, err_sum, n = {}, 0.0, 0.0, 0
        for sid, want_em in ref.items():
            got = np.load(os.path.join(em_dir, f"{sid}.npz"))["emission"]
            if got.shape != tuple(want_em.shape) or not np.isfinite(got).all():
                fail(f"decode {dt} {sid}: emissions {got.shape} vs {tuple(want_em.shape)}")
            e = (torch.from_numpy(got).cuda() - want_em).abs()
            err_max, err_sum, n = max(err_max, e.max().item()), err_sum + e.sum().item(), \
                n + e.numel()
            ems[sid] = got
        tol = EM_TOL[dt]
        if err_max > tol[0] or err_sum / n > tol[1]:
            fail(f"decode {dt}: emissions differ from the plain path: max {err_max} "
                 f"mean {err_sum / n} (tolerance {tol})")
        # device time of the top-k forward, summed over the list's batches
        fwd_ms = 0.0
        for spec in ds.batch_specs():
            batch = ds.materialize(spec)
            ev.emissions_topk(batch, DECODE_K)
            prof = profile_device(lambda: ev.emissions_topk(batch, DECODE_K))
            fwd_ms += sum(e.self_device_time_total for e in device_events(prof)) / 1e3
        # the top-k cut against the full rows, utterance by utterance
        cfg = Config()
        cfg.update(ev.cfg.asdict())
        cfg.update(dict(lm=arpa, beamsize=100, beamsizetoken=DECODE_K, beamthreshold=25.0,
                        lmweight=1.0, wordscore=0.5, smearing="max"))
        dec, word_dict = build_decoder(cfg, ev.token_dict, ev.lexicon)
        if not isinstance(dec, NativeBeamDecoder):
            fail(f"decode {dt}: build_decoder gave {type(dec).__name__}")
        blank, sep = ev.n_classes - 1, ev.token_dict.get_index(cfg.wordseparator)
        per_utt, bad = {}, []
        for sid, e in ems.items():
            top = -np.partition(-e, DECODE_K, axis=1)[:, :DECODE_K + 1]
            top.sort(axis=1)
            kth, next_ = top[:, 1], top[:, 0]  # the k-th and (k+1)-th largest
            vals, idx = torch.topk(torch.from_numpy(e), DECODE_K, dim=-1)
            cut = sparse_rows(vals.numpy(), idx.to(torch.int32).numpy(), ev.n_classes)
            words = result_to_words(dec.decode(cut)[0], word_dict, ev.token_dict, cfg,
                                    ev.n_classes)
            row = dict(frames=len(e), tied_frames=int((kth == next_).sum()),
                       blank_outside_k=int((e[:, blank] < kth).sum()),
                       separator_outside_k=int((e[:, sep] < kth).sum()),
                       topk_equals_host_cut=words == runs["topk"]["hyps"][sid],
                       topk_equals_full=runs["topk"]["hyps"][sid] == runs["full"]["hyps"][sid])
            per_utt[sid] = row
            if row["tied_frames"] == 0 and not row["topk_equals_host_cut"]:
                bad.append(sid)
        if bad:
            fail(f"decode {dt}: the shipped top-k decodes otherwise than the host's cut "
                 f"on {bad}, which tie at no k-th value")
        # the native beam against the Python beam at width PY_BEAM
        cfg.update(dict(beamsize=PY_BEAM))
        nat, _ = build_decoder(cfg, ev.token_dict, ev.lexicon)
        py, _ = build_decoder(cfg, ev.token_dict, ev.lexicon, use_native=False)
        py_rows = []
        for sid in sorted(ems, key=lambda k: len(ems[k]))[:2]:
            t0 = time.perf_counter()
            rn = nat.decode(ems[sid])[0]
            t1 = time.perf_counter()
            rp = py.decode(ems[sid])[0]
            t2 = time.perf_counter()
            wn, wp = (result_to_words(r, word_dict, ev.token_dict, cfg, ev.n_classes)
                      for r in (rn, rp))
            py_rows.append(dict(sid=sid, frames=len(ems[sid]), words=len(wn),
                                score_diff=abs(rn.score - rp.score), native_s=t1 - t0,
                                python_s=t2 - t1))
            if wn != wp or abs(rn.score - rp.score) > 1e-3 * max(1.0, abs(rp.score)):
                fail(f"decode {dt} {sid}: native {wn} ({rn.score}) vs Python {wp} "
                     f"({rp.score})")
        del ev, ds, ref, dec, nat, py
        torch.cuda.empty_cache()
        a = runs["topk"]
        decode_s = a["wall_s"] - a["setup_s"]
        results[dt] = dict(
            utterances=len(ems), audio_s=secs, lm_prep_s=prep_s,
            decode_s=decode_s, audio_s_per_wall_s=secs / decode_s,
            setup_s=a["setup_s"], forward_host_s=a["forward_s"],
            forward_device_ms=fwd_ms, beam_host_s=a["beam_s"],
            WER={k: r["WER"] for k, r in runs.items()},
            launches=a["launches"], em_max_abs_err=err_max, em_mean_abs_err=err_sum / n,
            em_tol=tol, tied_frames=sum(r["tied_frames"] for r in per_utt.values()),
            frames=sum(r["frames"] for r in per_utt.values()),
            utterances_without_tie=sum(r["tied_frames"] == 0 for r in per_utt.values()),
            blank_outside_k=sum(r["blank_outside_k"] for r in per_utt.values()),
            separator_outside_k=sum(r["separator_outside_k"] for r in per_utt.values()),
            topk_equals_full=sum(r["topk_equals_full"] for r in per_utt.values()),
            per_utterance=per_utt, python_beam=py_rows)
        log(f"[decode flagship {dt}] {json.dumps(results[dt])}")
        log(f"[decode rate] {dt}: {secs / decode_s:.1f} audio s per wall s "
            f"(forward {fwd_ms:.2f} ms device, {a['forward_s']:.3f} s host; beam "
            f"{a['beam_s']:.3f} s host over 2 threads) | {smi_line}")
    results["phase_s"] = time.perf_counter() - t_phase
    log(f"[decode] phase 10 in {results['phase_s']:.1f} s")
    return results

# ---------------------------------------------------------------------------
# phase 11: chunked streaming inference
# ---------------------------------------------------------------------------
STREAM_CHUNK = 8000  # samples, 500 ms at 16 kHz
STREAM_LOOK_BACK = 25  # frames: cli.streaming_asr's prune(look_back=250 ms / 10 ms)
STREAM_DECODER = {"beamSize": 100, "beamSizeToken": DECODE_K, "beamThreshold": 25,
                  "lmWeight": 1.0, "wordScore": 0.5}
STREAM_MULTI = 4  # utterances (the shortest) and threads of cli.streaming_asr_multi
STREAM_EM_TOL = 1e-4  # max |streamed - batch| emissions (tests/test_streaming.py)
# max |streamed - batch| features (tests/test_streaming.py), on every frame,
# against the batch featurizer's K1 on the whole utterance with its local CMVN
# in float64, as the stream's. The batch featurizer's own fp32 CMVN is not the
# yardstick: its fp32 E[x^2] - E[x]^2 cancels in short or steady windows
# (ROADMAP.md queue 3), so its distance is reported beside, not held
STREAM_FEAT_TOL = 2e-3


def stream_launches(layers, frames, n_in, start=0):
    """(K2, K3, calls) of pushing ``n_in`` frames into layer ``start`` of a
    stream whose layers hold ``frames`` frames of state (updated in place):
    one K2 for each time-only conv and each TDS block that emits frames (by
    its ``out_frames``), two K3 for each such block; ``calls`` lists their
    shapes, [("time_conv", (B, T, F, C, CO, K, stride, pads))] and
    [("residual_ln", (R, D))]."""
    from wav2letter_tpu_torch.inference.streaming import StreamConv, StreamTDS

    k2 = k3 = 0
    calls, n = [], n_in
    for i in range(start, len(layers)):
        layer = layers[i]
        if not isinstance(layer, (StreamConv, StreamTDS)):
            continue
        m = frames[i] + n
        n, frames[i] = layer.out_frames(frames[i], n)
        tds = isinstance(layer, StreamTDS)
        if n and (tds or layer.module.time_only):
            k2 += 1
            mod = layer.module
            if tds:
                k3 += 2
                calls += [("time_conv", (1, m, mod.f, mod.c, mod.c, mod.w, 1, (0, 0))),
                          ("residual_ln", (n, mod.c * mod.f))]
            else:
                calls.append(("time_conv", (1, m, layer.freq_dim, mod.in_ch, mod.out_ch,
                                            mod.wx, mod.sx, (0, 0))))
    return k2, k3, calls


def finish_launches(layers, frames):
    """(K2, K3) of ``StreamingNetwork.finish``: each layer's right pad pushed
    through it and the layers after it."""
    k2 = k3 = 0
    for i, layer in enumerate(layers):
        if layer.flush_frames():
            a, b, _ = stream_launches(layers, frames, layer.flush_frames(), i)
            k2, k3 = k2 + a, k3 + b
    return k2, k3


def stream_one(net, featp, audio, dec, check=True):
    """One utterance through the streaming featurizer, network and the
    online beam at batch 1 in ``STREAM_CHUNK`` chunks, as
    ``cli.streaming_asr`` does it (best hypothesis, then ``prune``, after
    every chunk). With ``check``, every chunk's launches are held to what
    its frames imply. Returns the per-chunk rows, the features, the
    emissions, the frames each chunk emitted and the final words' result."""
    import numpy as np
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.inference import StreamingFeaturizer

    sf = StreamingFeaturizer(featp, "cuda")
    fstate, states = sf.start(), net.start(1)
    dec.decode_begin()
    rows, feats, ems, cut, calls = [], [], [], [], []
    for pos in range(0, len(audio), STREAM_CHUNK):
        t0 = time.perf_counter()
        kernels.reset_launches()
        fstate, f = sf.run(fstate, audio[pos:pos + STREAM_CHUNK])
        torch.cuda.synchronize()
        k1 = kernels.LAUNCHES["mfsc"]
        t1 = time.perf_counter()
        em = np.zeros((0, 0), np.float32)
        k2 = k3 = 0
        frames = [0 if s is None else s.shape[1] for s in states]
        if len(f):
            kernels.reset_launches()
            states, y = net.run(states, f[None, :, :, None])
            em = y[0, :, 0, :].cpu().numpy()
            k2, k3 = kernels.LAUNCHES["time_conv"], kernels.LAUNCHES["residual_ln"]
        t2 = time.perf_counter()
        if len(em):
            dec.decode_step(em)
        dec.get_best_hypothesis(0)
        dec.prune(look_back=STREAM_LOOK_BACK)
        t3 = time.perf_counter()
        if check:
            want = stream_launches(net.layers, frames, len(f))
            if k1 != int(len(f) > 0) or (k2, k3) != want[:2]:
                fail(f"stream chunk at {pos}: launches K1 {k1} K2 {k2} K3 {k3}, expected "
                     f"{int(len(f) > 0)} {want[0]} {want[1]}")
            calls.append(want[2])
        rows.append(dict(feat_ms=1e3 * (t1 - t0), net_ms=1e3 * (t2 - t1),
                         beam_ms=1e3 * (t3 - t2), frames_in=len(f), frames_out=len(em),
                         k1=k1, k2=k2, k3=k3))
        feats.append(f)
        ems.append(em)
        cut.append(len(em))
    frames = [0 if s is None else s.shape[1] for s in states]
    kernels.reset_launches()
    states, y = net.finish(states)
    got = (kernels.LAUNCHES["time_conv"], kernels.LAUNCHES["residual_ln"])
    if check and got != finish_launches(net.layers, frames):
        fail(f"stream finish: launches {got}, expected {finish_launches(net.layers, frames)}")
    tail = np.zeros((0, 0), np.float32) if y is None else y[0, :, 0, :].cpu().numpy()
    if len(tail):
        dec.decode_step(tail)
    dec.decode_end()
    ems.append(tail)
    return dict(rows=rows, feats=torch.cat(feats), em=np.concatenate([e for e in ems if len(e)]),
                cut=cut, tail=len(tail), result=dec.get_best_hypothesis(), calls=calls)


def decode_cut(dec, em, cut, tail):
    """The beam fed ``em`` cut at a stream's chunk boundaries (``cut`` frames
    a chunk, then ``tail`` at finish), with the stream's ``prune`` calls."""
    dec.decode_begin()
    pos = 0
    for n in cut:
        if n:
            dec.decode_step(em[pos:pos + n])
        dec.get_best_hypothesis(0)
        dec.prune(look_back=STREAM_LOOK_BACK)
        pos += n
    if tail:
        dec.decode_step(em[pos:pos + tail])
    dec.decode_end()
    return dec.get_best_hypothesis()


def graph_ms(fn, args, iters=20, reps=10) -> float:
    """Device time per call of ``fn(*args)``, L2-warm and back to back: CUDA
    events around replays of a CUDA graph of ``iters`` calls, so the host's
    launch cost, which exceeds these kernels' device time, is left out. The
    profiler is not used for these: at a few microseconds a call, some of its
    readings held a tenth of the launches made."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, before capture
        for _ in range(3):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def stream_conv_rows(key):
    """K2, its dgrad and K2b in fp32 at one conv of a steady stream chunk
    (B = 1, a window of state and chunk frames, no pads) against their plain
    versions and one PyTorch call each, timed by ``graph_ms``; K2b twice for
    equal bits. Only K2 runs on the stream (a chunk has no backward): the
    gradients' rows check and time the kernels at the stream's small B * T,
    where the schedule splits the taps."""
    import torch
    import torch.nn.functional as F

    from wav2letter_tpu_torch import kernels

    B, T, Fq, C, CO, K, s, pads = key
    x, w, bias, dy = _conv_inputs(key, torch.float32)
    xn = x.view(B, T, Fq, C).permute(0, 3, 2, 1).contiguous()
    wn = w.permute(2, 1, 0).unsqueeze(2).contiguous()
    Tout = dy.shape[1]
    dyn = dy.view(B, Tout, Fq, CO).permute(0, 3, 2, 1).contiguous()
    flops = 2 * B * Tout * Fq * CO * K * C
    shape = list(key[:7]) + [list(pads)]
    calls = (
        ("time_conv", "conv", (x, w, Fq, s, pads, bias, True), kernels.time_conv,
         kernels.time_conv_plain, lambda a, b_, c: F.conv2d(a, b_, c, stride=(1, s)),
         (xn, wn, bias), 4 * (x.numel() + w.numel() + dy.numel() + CO)),
        ("time_conv_dgrad", "dgrad", (dy, w, Fq, T, s, pads), kernels.time_conv_dgrad,
         kernels.time_conv_dgrad_plain,
         lambda a, b_: torch.nn.grad.conv2d_input(xn.shape, b_, a, stride=(1, s)), (dyn, wn),
         4 * (dy.numel() + w.numel() + x.numel())),
        ("time_conv_wgrad", "wgrad", (x, dy, K, Fq, s, pads), kernels.time_conv_wgrad,
         kernels.time_conv_wgrad_plain,
         lambda a, b_: torch.nn.grad.conv2d_weight(a, wn.shape, b_, stride=(1, s)), (xn, dyn),
         4 * (x.numel() + dy.numel() + w.numel())))
    rows = []
    for name, kind, args, fn, plain, lib, lib_args, nbytes in calls:
        got = fn(*args)
        err, rel, ok = compare(name, "float32", got, plain(*args))
        if kind == "wgrad":
            ok = ok and torch.equal(got, fn(*args))  # ordered sums
        b_ms, b_by = bound(nbytes, flops, "float32")
        ms = graph_ms(fn, args)
        rows.append(dict(
            name=name, dtype="float32", shape=shape, tag="stream", max_abs_err=err,
            max_rel_err=rel, tol=TOL[(name, "float32")], ok=ok, ms=ms,
            plain_ms=graph_ms(plain, args), library_ms=graph_ms(lib, lib_args), bound_ms=b_ms,
            bound_by=b_by, tflops=flops / ms / 1e9, calls=int(kind == "conv"),
            **_conv_layout(torch.float32, key, kind, Tout)))
        _conv_log(rows[-1], "stream")
    return rows


def stream_chunk_k2_ms(convs):
    """Device time of a steady chunk's K2 launches (``convs``, one per call,
    in order), replayed back to back from one CUDA graph: what the chunk's
    device time holds of K2, without the host's launch cost."""
    import torch

    from wav2letter_tpu_torch import kernels

    args = []
    for key in convs:
        x, w, bias, _ = _conv_inputs(key, torch.float32)
        args.append((x, w, key[2], key[6], key[7], bias, True))

    def chunk():
        for a in args:
            kernels.time_conv(*a)

    return graph_ms(chunk, ())


def stream_kernel_rows(featurizer, S, convs, lns, details):
    """K1 at a chunk's samples S, K2 and K3 at streaming shapes (B = 1
    windows, a few rows), against their plain versions and one PyTorch call
    of the same function where there is one, timed per launch by
    ``graph_ms``, with L2-warm inputs as a stream finds them."""
    import torch
    import torch.nn.functional as F

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.kernels.layernorm import route as ln_route
    from wav2letter_tpu_torch.kernels.mfsc import route as mfsc_route

    rows = []
    p = featurizer.p
    pre = 0.5 * torch.randn((1, S), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(S))
    args = (pre, featurizer.cos_mat, featurizer.sin_mat, featurizer.mel_fb, p.frame_samples,
            p.stride_samples, p.mel_floor)
    got = kernels.mfsc(*args)
    err, rel, ok = compare("mfsc", "float32", got, kernels.mfsc_plain(*args))
    nb, nm = featurizer.mel_fb.shape
    T = got.shape[1]
    nnz = int((featurizer.mel_fb != 0).sum())
    b_ms, b_by = bound(4 * (S + 2 * p.frame_samples * nb + nb * nm + T * nm),
                       T * (2.5 * p.n_fft * math.log2(p.n_fft) + 4 * nb + 2 * nnz + nm),
                       "float32")  # as _mfsc_row counts the function's work
    rows.append(dict(
        name="mfsc", dtype="float32", shape=[1, S, T], tag="stream", max_abs_err=err,
        max_rel_err=rel, tol=TOL[("mfsc", "float32")], ok=ok, ms=graph_ms(kernels.mfsc, args),
        plain_ms=graph_ms(kernels.mfsc_plain, args), library_ms=None, bound_ms=b_ms,
        bound_by=b_by, route=mfsc_route(p.frame_samples, p.stride_samples, nb, nm)))
    for key in convs:
        rows.extend(stream_conv_rows(key))
    for R, D in lns:
        x, y, w, b = _ln_inputs(R + 4, D, torch.float32, R + D)
        x, y = x[2:2 + R], y[:R].contiguous()  # the residual: a time slice of a window
        args = (x, y, w, b)
        err, rel, ok = _ln_compare("float32", kernels.residual_ln(*args),
                                   kernels.residual_ln_plain(*args))
        wd, bd = w.expand(D).contiguous(), b.expand(D).contiguous()
        b_ms, b_by = bound(12 * R * D + 8 * R + 8, 8 * R * D, "float32")
        rows.append(dict(
            name="residual_ln", dtype="float32", shape=[R, D], tag="stream", max_abs_err=err,
            max_rel_err=rel, tol=TOL[("residual_ln", "float32")], ok=ok,
            ms=graph_ms(kernels.residual_ln, args),
            plain_ms=graph_ms(kernels.residual_ln_plain, args),
            library_ms=graph_ms(lambda a, a2, c, d: F.layer_norm(a + a2, (D,), c, d, 1e-5),
                                (x, y, wd, bd)),
            bound_ms=b_ms, bound_by=b_by, route=ln_route(D, 4, x.data_ptr() % 16 == 0)))
    for r in rows:
        r["warm_ms"] = r["ms"]
        log(f"[stream kernel] {json.dumps(r)}")
        details.append(r)
    return rows


def stream_path(paths, lst, secs, tmp, smi_line):
    """Phase 11: the flagship's fp32 checkpoint through
    ``cli.convert_streaming``, then the list's utterances streamed at batch 1
    in 500 ms chunks through the Python API with the online Python beam
    (phase 10's lexicon and ARPA; beam 100, beamSizeToken 100, threshold 25).
    Checks each chunk's launches, the streamed emissions against the batch
    fp32 forward on the same features, the streamed features against the
    batch featurizer, the streamed words against the same decoder fed the
    batch emissions at the stream's chunk boundaries, ``cli.streaming_asr``
    (its main, its printed lines read back) and ``cli.streaming_asr_multi``
    (4 threads) against the in-process words, and K2 and K3 at streaming shapes against their plain
    versions."""
    import contextlib
    import io

    import numpy as np
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.cli import convert_streaming, streaming_asr, streaming_asr_multi
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data import read_list_file
    from wav2letter_tpu_torch.data.audio import load_audio
    from wav2letter_tpu_torch.features import FeatureParams, Featurizer
    from wav2letter_tpu_torch.features.frontend import local_normalize
    from wav2letter_tpu_torch.inference import StreamingFeaturizer, load_streaming_bundle
    from wav2letter_tpu_torch.models import build_arch_module
    from wav2letter_tpu_torch.runtime.checkpoint import load_checkpoint

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "stream")
    os.makedirs(root, exist_ok=True)
    bundle = os.path.join(root, "flagship.stream")
    with contextlib.redirect_stdout(io.StringIO()):
        convert_streaming.main([f"--am={paths['float32']}", f"--out={bundle}"])
    t0 = time.perf_counter()
    net, featp, meta = load_streaming_bundle(bundle, "cuda")
    opts = os.path.join(root, "decoder.json")
    with open(opts, "w") as f:
        json.dump(STREAM_DECODER, f)
    ckpt = load_checkpoint(paths["float32"])
    cfg = Config.deserialize(ckpt.config)
    dargs = {"lexicon_file": cfg.lexicon,
             "language_model_file": os.path.join(tmp, "decode", "lm.arpa"),
             "decoder_options_file": opts}
    dec, word_dict, tok_dict, blank = streaming_asr.build_decoder(dargs, meta)
    wsep = str(meta["wordseparator"])
    setup_s = time.perf_counter() - t0
    samples = read_list_file(lst)
    audio = {s.sample_id: load_audio(s.audio_path, featp.sample_rate) for s in samples}

    # warm-up (cuBLAS, the modules' re-indexed weights): 2 s, checked, not kept
    stream_one(net, featp, audio[samples[0].sample_id][:32000], dec)
    torch.cuda.synchronize()
    t_stream = time.perf_counter()
    streamed = {sid: stream_one(net, featp, a, dec) for sid, a in audio.items()}
    stream_s = time.perf_counter() - t_stream
    words = {sid: streaming_asr.result_words(r["result"], word_dict, tok_dict, blank, wsep)
             for sid, r in streamed.items()}

    # against the batch path: features, emissions, and the beam on batch emissions
    model = build_arch_module(ARCH, N_FEAT, len(meta["tokens"]))
    model.load_state_dict(ckpt.state_dict)
    model.cuda().eval()
    batch_feat = Featurizer(FeatureParams.from_config(cfg)).cuda()
    raw_feat = Featurizer(FeatureParams(n_filterbanks=N_FEAT)).cuda()
    em_err = feat_err = feat_err_head = feat_err_fp32 = 0.0
    fp32_worst = None
    ref_dec, _, _, _ = streaming_asr.build_decoder(dargs, meta)
    bad_words = []
    for sid, r in streamed.items():
        x = torch.from_numpy(audio[sid]).cuda()[None]
        with torch.no_grad():
            bf = batch_feat(x)[0][0]
            # the batch path's K1 on the whole utterance, its CMVN in float64
            bf64 = local_normalize(raw_feat(x)[0].double(), featp.local_norm_left, 0)[0]
            bem = model(r["feats"][None])[0][0].cpu().numpy()
        if bf.shape != r["feats"].shape or bem.shape != r["em"].shape:
            fail(f"stream {sid}: features {tuple(r['feats'].shape)} vs {tuple(bf.shape)}, "
                 f"emissions {r['em'].shape} vs {bem.shape}")
        if not np.isfinite(r["em"]).all():
            fail(f"stream {sid}: non-finite emissions")
        fe = (r["feats"].double() - bf64).abs()
        feat_err, feat_err_head = max(feat_err, fe[8:].max().item()), max(feat_err_head,
                                                                         fe[:8].max().item())
        e32 = (r["feats"] - bf).abs().amax(dim=1)
        if e32[8:].max().item() > feat_err_fp32:
            feat_err_fp32 = e32[8:].max().item()
            fp32_worst = dict(utterance=sid, frame=8 + int(e32[8:].argmax()),
                              frames=len(e32))
        em_err = max(em_err, float(np.abs(r["em"] - bem).max()))
        ref = decode_cut(ref_dec, bem, r["cut"], r["tail"])
        ref_words = streaming_asr.result_words(ref, word_dict, tok_dict, blank, wsep)
        if ref_words != words[sid]:
            bad_words.append(sid)
    if em_err >= STREAM_EM_TOL or max(feat_err, feat_err_head) >= STREAM_FEAT_TOL:
        fail(f"stream: emissions {em_err} (bound {STREAM_EM_TOL}) or features {feat_err}, "
             f"first 8 frames {feat_err_head} (bound {STREAM_FEAT_TOL}) differ from the "
             f"batch path")
    if bad_words:
        fail(f"stream: streamed words differ from the batch-fed beam's on {bad_words}")

    # the CLIs, through their mains in this process: streaming_asr on the
    # shortest utterance (its printed lines read back), streaming_asr_multi
    # on the 4 shortest with 4 threads
    by_len = sorted(audio, key=lambda k: len(audio[k]))
    short = next(s for s in samples if s.sample_id == by_len[0])
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        streaming_asr.main([f"--bundle={bundle}", f"--input_audio_file={short.audio_path}",
                            f"--lexicon_file={dargs['lexicon_file']}",
                            f"--language_model_file={dargs['language_model_file']}",
                            f"--decoder_options_file={opts}"])
    cli_s = time.perf_counter() - t0
    cli_words = printed.getvalue().split("[final]")[-1].split()
    if cli_words != words[short.sample_id]:
        fail(f"cli.streaming_asr printed {cli_words}, the stream gave {words[short.sample_id]}")
    multi = [s for s in samples if s.sample_id in by_len[:STREAM_MULTI]]
    margs = [f"--bundle={bundle}", f"--input_files={','.join(s.audio_path for s in multi)}",
             f"--max_num_threads={STREAM_MULTI}", f"--lexicon_file={dargs['lexicon_file']}",
             f"--language_model_file={dargs['language_model_file']}", "--beam_size=100",
             "--beam_threshold=25", "--lm_weight=1", "--word_score=0.5"]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        streaming_asr_multi.main(margs)
    multi_s = time.perf_counter() - t0
    printed = dict(line.split(": ", 1) for line in out.getvalue().splitlines())
    factory, _, _, _ = streaming_asr_multi.bundle_factory(
        streaming_asr_multi.parse_args(margs), meta)
    for s in multi:  # each stream's single-thread words, from its own emissions
        r = streamed[s.sample_id]
        d = factory.make()
        d.decode_begin()
        pos = 0
        for n in r["cut"] + [r["tail"]]:
            if n:
                d.decode_step(r["em"][pos:pos + n])
            pos += n
        d.decode_end()
        want = " ".join(streaming_asr.result_words(d.get_best_hypothesis(),
                                                   factory.word_dict, tok_dict, blank, wsep))
        if printed.get(s.audio_path, None) != want:
            fail(f"cli.streaming_asr_multi printed {printed.get(s.audio_path)!r} for "
                 f"{s.sample_id}, a single stream gives {want!r}")

    # device time of one utterance's featurizer and network, and their wall
    first = audio[samples[0].sample_id]
    sf = StreamingFeaturizer(featp, "cuda")

    def feat_net():
        fs, st = sf.start(), net.start(1)
        for pos in range(0, len(first), STREAM_CHUNK):
            fs, f = sf.run(fs, first[pos:pos + STREAM_CHUNK])
            if len(f):
                st, y = net.run(st, f[None, :, :, None])
                y.cpu()
        net.finish(st)

    feat_net()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feat_net()
    torch.cuda.synchronize()
    fn_wall_ms = 1e3 * (time.perf_counter() - t0)
    prof = profile_device(feat_net)
    by_kernel = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                        for e in device_events(prof)), reverse=True)
    busy = sum(r[0] for r in by_kernel)
    n_chunks = len(streamed[samples[0].sample_id]["rows"])

    # K1, K2 and K3 at the shapes of a steady chunk of the first utterance
    calls = streamed[samples[0].sample_id]["calls"][len(streamed[samples[0].sample_id]
                                                         ["calls"]) // 2]
    convs = [c for k, c in calls if k == "time_conv"]
    lns = [c for k, c in calls if k == "residual_ln"]
    details = []
    S = featp.frame_samples + featp.stride_samples * (
        max(r["frames_in"] for r in streamed[samples[0].sample_id]["rows"]) - 1)
    k_rows = stream_kernel_rows(sf.featurizer, S, [convs[0], convs[1], convs[-1]],
                                [lns[0], lns[4], lns[-1]], details)
    if not all(r["ok"] for r in k_rows):
        fail(f"stream kernels disagree with their plain versions: "
             f"{[r for r in k_rows if not r['ok']]}")
    k2_chunk_ms = stream_chunk_k2_ms(convs)
    log(f"[stream] a steady chunk's {len(convs)} K2 launches: {k2_chunk_ms:.4f} ms of device "
        f"time (graph replay) | {smi_line}")

    rows = [row for r in streamed.values() for row in r["rows"]]
    lat = {k: np.asarray([row[k] for row in rows]) for k in ("feat_ms", "net_ms", "beam_ms")}
    total = lat["feat_ms"] + lat["net_ms"] + lat["beam_ms"]

    def pct(a):
        return dict(p50=float(np.percentile(a, 50)), p95=float(np.percentile(a, 95)))

    results = dict(
        utterances=len(streamed), audio_s=secs, chunks=len(rows), setup_s=setup_s,
        stream_s=stream_s, x_real_time=secs / stream_s,
        latency_ms=dict(total=pct(total), **{k[:-3]: pct(v) for k, v in lat.items()}),
        launches={k: sum(row[k] for row in rows) for k in ("k1", "k2", "k3")},
        k2_chunk=dict(launches=len(convs), ms=k2_chunk_ms, shapes=convs),
        em_max_abs_err=em_err, em_tol=STREAM_EM_TOL, feat_max_abs_err_after_8=feat_err,
        feat_max_abs_err_first_8=feat_err_head, feat_tol=STREAM_FEAT_TOL,
        feat_max_abs_err_fp32_cmvn_after_8=feat_err_fp32, feat_fp32_cmvn_worst=fp32_worst,
        words=sum(len(w) for w in words.values()), cli_s=cli_s, multi_s=multi_s,
        multi_utterances=len(multi),
        profile=dict(utterance=samples[0].sample_id, chunks=n_chunks, wall_ms=fn_wall_ms,
                     device_busy_ms=busy, device_busy_ms_per_chunk=busy / n_chunks,
                     idle_share=1 - busy / fn_wall_ms,
                     idle_share_with_beam=1 - busy / sum(
                         row["feat_ms"] + row["net_ms"] + row["beam_ms"]
                         for row in streamed[samples[0].sample_id]["rows"]),
                     top=[dict(ms=round(ms, 4), kernel=k[:90], count=c)
                          for ms, k, c in by_kernel[:12]]),
        kernels=details, phase_s=time.perf_counter() - t_phase)
    log(f"[stream flagship float32] {json.dumps({k: v for k, v in results.items() if k != 'kernels'})}")
    log(f"[stream rate] {secs / stream_s:.1f} audio s per wall s; chunk latency p50 "
        f"{results['latency_ms']['total']['p50']:.2f} ms, p95 "
        f"{results['latency_ms']['total']['p95']:.2f} ms (featurizer "
        f"{results['latency_ms']['feat']['p50']:.2f}, network "
        f"{results['latency_ms']['net']['p50']:.2f}, beam "
        f"{results['latency_ms']['beam']['p50']:.2f} ms p50); device busy "
        f"{busy / n_chunks:.3f} ms a chunk, idle share {1 - busy / fn_wall_ms:.3f} | {smi_line}")
    log(f"[stream] phase 11 in {results['phase_s']:.1f} s")
    return results


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# 12. data and tensor parallelism: ranks through torch.distributed
# ---------------------------------------------------------------------------
DP_RANKS, DP_BATCH, DP_UPDATES = 2, 4, 2  # ranks on the one card, rows a rank, updates
DP_DYN_SECS = 30.0  # --batching_max_duration a rank (the global budget is twice it)
DP_TIMEOUT = 420  # seconds for all the ranks' jobs
TP_LAYERS = 2  # of the transformer's 12, at dp1 x mp2
# Two ranks (or one NCCL rank, or a dp1 x mp2 mesh) against one process on the
# same global batch after the run's updates: the largest relative difference
# of a loss, and of the distance the parameters moved (|P - Q| / |Q - P0| over
# the whole model, P0 the seeded start). Both sides compute the same sums with
# the rows in other batches, so cuBLAS and cuDNN take other algorithms, and
# CTC's backward adds with atomics. The seeded flagship amplifies rounding
# ~1e4-fold on the way back (GRAD_TOL: 1e-2 of a gradient in fp32, 0.25 in
# bf16); over a few updates that is 2e-2 of the distance moved in fp32.
DP_TOL = {"float32": (1e-3, 2e-2), "bfloat16": (2e-2, 0.25)}


def _probe_collectives(rank, world):
    """gloo's all-reduce, broadcast and all-gather of CUDA tensors: "ok", or
    what went wrong."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    out = {}
    for name in ("all_reduce", "broadcast", "all_gather"):
        x = torch.full((4,), float(rank + 1), device=dev)
        try:
            if name == "all_reduce":
                dist.all_reduce(x)
                got, want = x, world * (world + 1) / 2
            elif name == "broadcast":
                dist.broadcast(x, 0)
                got, want = x, 1.0
            else:
                parts = [torch.empty_like(x) for _ in range(world)]
                dist.all_gather(parts, x)
                got, want = torch.stack(parts)[:, 0], torch.arange(1.0, world + 1, device=dev)
            torch.cuda.synchronize()
            out[name] = "ok" if torch.equal(got, torch.as_tensor(want, device=dev).expand_as(
                got)) else f"wrong: {got.tolist()}"
        except (RuntimeError, ValueError) as e:
            out[name] = f"refused: {type(e).__name__}: {str(e)[:200]}"
    return out


def _drive(tr, spy_heads=None):
    """``tr.run()`` with the launch counts set to 0 just before and read just
    after, each update timed (drained), the gradient reduction timed (drained
    at both ends), and the peak device memory."""
    import torch

    import wav2letter_tpu_torch.runtime.train as train_module
    from wav2letter_tpu_torch import kernels

    steps, reduce_ms, step = [], [], tr.train_step
    reduce = train_module.all_reduce_grads

    def timed_reduce(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce(*a)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)

    def timed_step(*a):
        res = step(*a)
        torch.cuda.synchronize()
        steps.append((time.perf_counter(), res[0], res[1]))
        return res

    tr.train_step = timed_step
    train_module.all_reduce_grads = timed_reduce
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        tr.run()
        torch.cuda.synchronize()
    finally:
        train_module.all_reduce_grads = reduce
        tr.train_step = step
    launches = dict(kernels.LAUNCHES)
    ends = [t0] + [e for e, _, _ in steps]
    update_ms = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
    steady = update_ms[1:] or update_ms
    res = dict(
        updates=tr.updates, losses=[l for _, l, _ in steps], finite=all(f for _, _, f in steps),
        launches=launches, update_ms=update_ms, updates_per_s=1e3 * len(steady) / sum(steady),
        reduce_ms=reduce_ms, reduce_share=(sum(reduce_ms[1:]) / sum(steady)
                                           if len(reduce_ms) > 1 else None),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        valid={t: m.tkn_edit.state() + m.wrd_edit.state() + m.loss.state()
               for t, m in tr.meters.valid.items()},
        sharded=sorted(tr.sharded))
    if spy_heads is not None:
        res["heads"] = sorted(set(spy_heads))
    return res


def _dp_job(job, rank):
    """One trainer of the ranks' job list; rank 0 keeps the full parameters
    (gathered over the model group where they are split) for the comparison."""
    import hashlib

    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.runtime.train import Trainer

    cfg = Config()
    cfg.update(job["flags"])
    heads = []
    mhsa = kernels.KERNELS.mhsa
    if job.get("spy_heads"):
        kernels.KERNELS.mhsa = lambda *a: (heads.append(a[5]), mhsa(*a))[1]
    try:
        tr = Trainer(cfg, device="cuda:0")
        res = _drive(tr, heads if job.get("spy_heads") else None)
    finally:
        kernels.KERNELS.mhsa = mhsa
    full = {n: tr._full(n, t).cpu() for n, t in tr.model.state_dict().items()}
    h = hashlib.sha256()
    for n, t in full.items():
        h.update(n.encode())
        h.update(t.numpy().tobytes())
    res["digest"] = h.hexdigest()
    if rank == 0 and job.get("dump"):
        torch.save(full, job["dump"])
    del tr
    torch.cuda.empty_cache()
    return res


def _dp_rank(rank, world, init, jobs, out_dir):
    """One rank of phase 12 (a spawned process): gloo on the card, the probe,
    then the jobs; what it saw goes to ``out_dir/rank<R>.json``."""
    import traceback
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    result = dict(rank=rank, runs={})
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                                timeout=timedelta(seconds=120))
        result["probe"] = _probe_collectives(rank, world)
        for job in jobs:
            if job.get("needs") and result["probe"][job["needs"]] != "ok":
                continue
            result["runs"][job["name"]] = (_cpc_dp_job(job, rank) if job.get("cpc")
                                           else _dp_job(job, rank))
        dist.barrier()
    except Exception:  # reported to the parent, which fails the phase
        result["error"] = traceback.format_exc()
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
        if dist.is_initialized():
            dist.destroy_process_group()


def _run_ranks(world, jobs, out_dir):
    """Spawn the ranks, wait for all (a rank that fails ends the others),
    and return their results."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    init = "file://" + os.path.join(out_dir, "rendezvous")
    procs = [ctx.Process(target=_dp_rank, args=(r, world, init, jobs, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DP_TIMEOUT
    try:
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
    results = []
    for r, p in enumerate(procs):
        path = os.path.join(out_dir, f"rank{r}.json")
        if not os.path.exists(path):
            fail(f"data parallel: rank {r} ended with {p.exitcode} and no result")
        with open(path) as f:
            results.append(json.load(f))
        if "error" in results[-1]:
            fail(f"data parallel: rank {r} failed:\n{results[-1]['error']}")
    return results


def _one_process(flags, spy_heads=False):
    """The reference: one process, no group, on the same global batch."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.runtime.train import Trainer

    cfg = Config()
    cfg.update(flags)
    tr = Trainer(cfg, device="cuda")
    heads, mhsa = [], kernels.KERNELS.mhsa
    if spy_heads:
        kernels.KERNELS.mhsa = lambda *a: (heads.append(a[5]), mhsa(*a))[1]
    try:
        res = _drive(tr, heads if spy_heads else None)
    finally:
        kernels.KERNELS.mhsa = mhsa
    params = {k: v.detach().cpu().clone() for k, v in tr.model.state_dict().items()}
    return tr, res, params


def _held(name, dt, got, want, got_p, want_p, p0):
    """``got`` (losses, parameters) against the reference at DP_TOL."""
    import torch

    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    moved = torch.sqrt(sum((want_p[k] - p0[k]).double().pow(2).sum() for k in p0)).item()
    diff = {k: (got_p[k] - want_p[k]).double().norm().item() for k in p0}
    rel = math.sqrt(sum(v * v for v in diff.values())) / moved
    tol = DP_TOL[dt]
    res = dict(loss_rel_err=loss_err, param_rel_err=rel, moved=moved, tol=list(tol),
               worst=sorted(diff, key=diff.get)[-3:][::-1])
    res["ok"] = bool(len(got["losses"]) == len(want["losses"]) and loss_err <= tol[0]
                     and rel <= tol[1])
    log(f"[dp {name} {dt}] held to one process: {json.dumps(res)}")
    if not res["ok"]:
        fail(f"data parallel {name} {dt}: differs from one process: {res}")
    return res


def _cut_arch(src, dst, keep_tr=None):
    """A copy of ``src`` with dropout and layerdrop 0 and no SAUG line;
    ``keep_tr`` TR layers of the transformer."""
    with open(src) as f:
        lines = [l for l in f.read().splitlines()
                 if l.strip() and not l.startswith("#") and not l.startswith("SAUG")]
    out, n_tr = [], 0
    for l in lines:
        t = l.split()
        if t[0] == "DO":
            t[1] = "0.0"
        elif t[0] == "TDS":
            t[4] = "0.0"
        elif t[0] == "TR":
            n_tr += 1
            if keep_tr is not None and n_tr > keep_tr:
                continue
            t[5:7] = ["0.0", "0.0"]
        out.append(" ".join(t))
    with open(dst, "w") as f:
        f.write("\n".join(out) + "\n")
    return dst


def data_parallel_path(tmp, train_lst, serve_lst, tokens, lexicon, smi_line, seed):
    """Phase 12: the flagship at full width on two gloo ranks on the card (4
    rows each, fp32, and one update in bf16, dropout 0 and no SpecAugment)
    against one process at 8; dynamic batching likewise (fp32); the
    transformer's first ``TP_LAYERS`` layers at dp1 x mp2 (K4 and K4b on 2
    of 4 heads) against one process, where gloo gathers CUDA tensors; one NCCL rank through
    ``cli.train`` with torchrun's variables against one process. The same
    ranks run phase 19's BatchNorm, novograd and conv_glu jobs
    (``hook_parallel_jobs``) and phase 21's CPC jobs (``cpc_rank_jobs``, on
    phase 13's corpus, which this makes)."""
    import socket

    import torch

    from wav2letter_tpu_torch.cli.train import main as train_main
    from wav2letter_tpu_torch.models import build_arch_module
    from wav2letter_tpu_torch.runtime.checkpoint import load_checkpoint

    root = os.path.join(tmp, "dp")
    os.makedirs(root, exist_ok=True)
    fl_arch = _cut_arch(ARCH, os.path.join(root, "flagship_do0.arch"))
    tr_arch = _cut_arch(TR_ARCH, os.path.join(root, "transformer_do0.arch"), TP_LAYERS)
    fl_spec = dict(FLAGSHIP, arch=fl_arch, name="dp_flagship")
    tr_spec = dict(TRANSFORMER, arch=tr_arch, name="dp_transformer",
                   per_forward={"mfsc": 1, "mhsa": TP_LAYERS, "residual_ln": 2 * TP_LAYERS},
                   per_backward={"mhsa_bwd": TP_LAYERS, "residual_ln_bwd": 2 * TP_LAYERS})
    n = DP_RANKS * DP_BATCH

    def flags(spec, dt, batch, **kw):
        f = train_flags(spec, train_lst, serve_lst, tokens, lexicon, "", dt, DP_UPDATES)
        f.update(batchsize=batch, validbatchsize=batch, reportiters=DP_UPDATES, **kw)
        return f

    dyn = dict(batching_strategy="dynamic", valid="", iter=1)
    jobs = [
        dict(name="float32", flags=flags(fl_spec, "float32", DP_BATCH,
                                         rundir=os.path.join(root, "runs"))),
        dict(name="bfloat16", flags=flags(fl_spec, "bfloat16", DP_BATCH, valid="", iter=1),
             dump=os.path.join(root, "bfloat16.pt")),
        dict(name="dynamic", flags=flags(fl_spec, "float32", DP_BATCH, **dyn,
                                         batching_max_duration=DP_DYN_SECS),
             dump=os.path.join(root, "dynamic.pt")),
        dict(name="tp", flags=flags(tr_spec, "float32", n, valid="", iter=2, mp_axis=2),
             dump=os.path.join(root, "tp.pt"), needs="all_gather", spy_heads=True),
    ]
    hook_root = os.path.join(root, "hooks")
    hdata = hook_data(hook_root, seed)
    hook_cases, hook_jobs = hook_parallel_jobs(hook_root, hdata)
    # phase 21's CPC jobs on phase 20's utterances: phase 13's corpus, made
    # here (phase 13 finds it made)
    from wav2letter_tpu_torch.tools.soak import Soak

    soak = Soak(os.path.join(tmp, "soak"), corpus=os.path.join(tmp, "soak_corpus"),
                corpus_kw=SOAK_CORPUS, sizes=SOAK_SIZES, device="cuda")
    soak.phase_corpus()
    t0 = time.perf_counter()
    ranks = _run_ranks(DP_RANKS, jobs + hook_jobs + cpc_rank_jobs(root, soak.paths), root)
    ranks_s = time.perf_counter() - t0
    probe = ranks[0]["probe"]
    log(f"[dp] gloo on CUDA tensors, {DP_RANKS} ranks on one card: {json.dumps(probe)}")
    if probe["all_reduce"] != "ok" or probe["broadcast"] != "ok":
        fail(f"data parallel: gloo refused the collectives DP needs: {probe}")
    if "tp" not in ranks[0]["runs"]:
        log(f"[dp] tensor parallelism left out: gloo's all-gather {probe['all_gather']}")

    torch.cuda.empty_cache()
    p0 = {}
    for arch in (fl_arch, tr_arch):
        torch.manual_seed(0)  # the trainers' seed: their starting weights
        p0[arch] = {k: v.detach().clone()
                    for k, v in build_arch_module(arch, N_FEAT, N_TOKENS + 1).state_dict().items()}
    out = dict(probe=probe, ranks_s=ranks_s, backend="gloo (2 ranks on one card)")
    for name, r in ranks[0]["runs"].items():
        if name in hook_cases or name.startswith("cpc"):  # held in phases 19 and 21
            continue
        other = ranks[1]["runs"][name]
        spec = tr_spec if name == "tp" else fl_spec
        dt = "float32" if name in ("float32", "dynamic", "tp") else "bfloat16"
        valid_batches = 0 if name in ("bfloat16", "dynamic", "tp") else 1
        want = expected_launches(spec, r["updates"], valid_batches)
        for rr in (r, other):
            if rr["launches"] != want or not rr["finite"]:
                fail(f"data parallel {name}: launches {rr['launches']}, expected {want}; "
                     f"finite {rr['finite']}")
        if name != "tp" and r["digest"] != other["digest"]:
            fail(f"data parallel {name}: the replicas differ")
        job = jobs[[j["name"] for j in jobs].index(name)]
        ref_flags = dict(job["flags"], rundir="", mp_axis=1, batchsize=n, validbatchsize=n)
        if name == "dynamic":
            ref_flags["batching_max_duration"] = DP_DYN_SECS * DP_RANKS
        ref_tr, ref, ref_p = _one_process(ref_flags, spy_heads=name == "tp")
        if name == "float32":
            ref_fp32 = (ref_flags, ref, ref_p)
        if name == "tp" and (r["heads"] != [2] or ref["heads"] != [4] or r["sharded"] != sorted(
                [f"seq.{i:02d}_TR.{w}.weight" for i in (14, 15) for w in ("w1", "w2")]
                + ["seq.16_L.weight"])):
            fail(f"tensor parallel: K4 on {r['heads']} heads (one process {ref['heads']}), "
                 f"split {r['sharded']}")
        if name == "float32":
            ckpt = load_checkpoint(os.path.join(root, "runs", "dp_flagship_float32",
                                                "model_last.bin"))
            got_p = ckpt.state_dict
            model = build_arch_module(fl_arch, N_FEAT, N_TOKENS + 1)
            model.load_state_dict(got_p, strict=True)  # rank 0's checkpoint loads alone
            if ckpt.updates != DP_UPDATES:
                fail(f"data parallel: rank 0's checkpoint holds update {ckpt.updates}")
            # the ranks' summed validation counts against one process's on
            # the same weights: totals equal, errors equal but for argmax
            # ties that rounding may flip (<= 0.2% of the total)
            ref_tr.model.load_state_dict(got_p)
            ref_tr.validate()
            one = ref_tr.meters.valid["dev"]
            mine = r["valid"]["dev"]
            if r["valid"] != other["valid"] or mine[1] != one.tkn_edit.total \
                    or mine[3] != one.wrd_edit.total or mine[5] != one.loss.n \
                    or abs(mine[0] - one.tkn_edit.errors) > 2e-3 * mine[1] \
                    or abs(mine[2] - one.wrd_edit.errors) > 2e-3 * mine[3] \
                    or abs(mine[4] / mine[5] - one.loss.value()) > 1e-4 * one.loss.value():
                fail(f"data parallel: validation {r['valid']} / {other['valid']} against "
                     f"one process {one.tkn_edit.state() + one.wrd_edit.state()} "
                     f"{one.loss.state()}")
            r["valid_one_process"] = one.tkn_edit.state() + one.wrd_edit.state() + \
                one.loss.state()
        else:
            got_p = torch.load(job["dump"])
        r["held"] = _held(name, dt, r, ref, got_p, ref_p, p0[spec["arch"]])
        r["one_process"] = {k: ref[k] for k in ("losses", "updates_per_s", "update_ms",
                                                "peak_mem_gib", "heads") if k in ref}
        r["peak_mem_gib_ranks"] = [r["peak_mem_gib"], other["peak_mem_gib"]]
        out[name] = r
        log(f"[dp {name}] gloo x{DP_RANKS}: {r['updates_per_s']:.3f} updates/s, reduction "
            f"{json.dumps(r['reduce_ms'])} ms an update (share {r['reduce_share']}); peak "
            f"{r['peak_mem_gib_ranks']} GiB a rank; one process {ref['updates_per_s']:.3f} "
            f"updates/s")
        del ref_tr
        torch.cuda.empty_cache()

    out["hooks"] = hook_parallel_held(hook_root, hdata, hook_cases, ranks, smi_line)

    # one NCCL rank through the command line, as torchrun would start it,
    # against the fp32 run's one-process reference
    import wav2letter_tpu_torch.runtime.train as train_module
    from wav2letter_tpu_torch import kernels

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    saved = {k: os.environ.get(k) for k in env}
    reduce, step = train_module.all_reduce_grads, train_module.Trainer.train_step
    backends, steps, reduce_ms = [], [], []

    def recording_reduce(mesh, *a):
        backends.append(torch.distributed.get_backend(mesh.data_group))
        torch.cuda.synchronize()
        t = time.perf_counter()
        reduce(mesh, *a)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t) * 1e3)

    def recording_step(self, *a):
        res = step(self, *a)
        torch.cuda.synchronize()
        steps.append((time.perf_counter(), res[0]))
        return res

    os.environ.update(env)
    train_module.all_reduce_grads = recording_reduce
    train_module.Trainer.train_step = recording_step
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        tr = train_main(["train", "--enable_distributed", "--world_size=1"]
                        + [f"--{k}={v}" for k, v in ref_fp32[0].items()])
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    finally:
        train_module.all_reduce_grads = reduce
        train_module.Trainer.train_step = step
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    want = expected_launches(fl_spec, DP_UPDATES, 1)
    if backends != ["nccl"] * DP_UPDATES or launches != want \
            or torch.distributed.is_initialized():
        fail(f"NCCL rank: reductions {backends}, launches {launches} (expected {want}), "
             f"group left open: {torch.distributed.is_initialized()}")
    ends = [t for t, _ in steps]
    nccl = dict(updates=tr.updates, launches=launches, backend="nccl (one rank)",
                losses=[l for _, l in steps], wall_s=time.perf_counter() - t0,
                updates_per_s=(len(ends) - 1) / (ends[-1] - ends[0]), reduce_ms=reduce_ms,
                reduce_share=sum(reduce_ms[1:]) / (ends[-1] - ends[0]) / 1e3)
    got_p = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}
    nccl["held"] = _held("nccl", "float32", nccl, ref_fp32[1], got_p, ref_fp32[2], p0[fl_arch])
    out["nccl_one_rank"] = nccl
    log(f"[dp nccl] {json.dumps(nccl)}")
    del tr
    torch.cuda.empty_cache()
    log(f"[dp] {smi_line}: gloo numbers are gloo's (two processes on one card), not NCCL's")
    return out


# ---------------------------------------------------------------------------
# phase 13: the soak in small
# ---------------------------------------------------------------------------
# the corpus: train 3 min, dev and test 1 min each, in the JAX soak's --fast
# language; the flagship minus SAUG, bf16, B = 16 for 20 updates, reports at
# 10; the product chain's grids cut to 2 points, 4 homophone-slice and 4
# streamed utterances
SOAK_CORPUS = dict(train_hours=0.05, dev_minutes=1.0, test_minutes=1.0, n_words=150,
                   n_homophone_pairs=15, lm_sentences=2000)
SOAK_BATCH, SOAK_UPDATES, SOAK_REPORT = 16, 20, 10
SOAK_SIZES = dict(sweep=(0.0, 1.0, 1.0), wordscores=(0.5,), homo_utts=4,
                  homo_sweep=(0.0, 1.0, 1.0), stream_utts=4)
SOAK_WALL_S = 120  # the phase's budget; printed beside its wall time


def soak_path(tmp, smi_line):
    """Phase 13: ``wav2letter_tpu_torch/tools/soak.py`` in small at the
    flagship's full width. The port's ``synth_corpus.generate`` writes the
    corpus, its ``train_ngram_lm`` the 3-gram LM; the driver's own
    ``_train_regime`` trains in a child process (``cli.train``), SIGKILLs
    its process group once ``model_last.bin`` of update 10 is whole and
    resumes with a bare ``continue``; ``phase_profile`` takes the trained
    run's updates in this process at its largest and median batches (wall,
    device busy, idle share, peak memory), counts one update's launches and
    holds the kernels' features, loss and gradients against the plain
    versions at the largest batch (``GRAD_TOL``, bf16 and fp32); then
    ``phase_product`` runs the chain with the CLIs in this process (as the
    soak runs them): viterbi ``test`` with ``--sclite``, the
    beam without and with the LM, the ``--lmweight`` sweep over an
    ``--emission_dir``, the homophone slice, the beam dump and rescoring,
    ``convert_streaming``, 4 test utterances streamed with the split against
    offline, the top-k against the full-row decode. Checks: every step ran,
    the kill came after the checkpoint of update 10 and ``continue`` resumed
    from it and logged above it, the results hold every key of the JAX
    soak's (``SOAK_RESULTS.json``, but ``train_b32``), the streamed emissions
    are within ``STREAM_EM_TOL`` of the batch network on the same features,
    one update launched what phase 6 counts (1 K1, 15 K2 + 14 dgrad, 15 K2b,
    22 K3, 22 K3b), and the chain's forwards launched K1, K2 and K3 and no
    backward kernel."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.tools.soak import Soak, missing_keys

    t_phase = time.perf_counter()
    s = Soak(os.path.join(tmp, "soak"), corpus=os.path.join(tmp, "soak_corpus"),
             corpus_kw=SOAK_CORPUS, sizes=SOAK_SIZES, device="cuda")
    s.phase_corpus()
    s.phase_lm()
    # the B = 128 regime's code and name, at B = 16
    ep = max(1, SOAK_UPDATES * SOAK_BATCH // s.n_train_utts)
    s._train_regime("b128", SOAK_BATCH, 0.2, SOAK_UPDATES, SOAK_REPORT,
                    kill_at=SOAK_REPORT, lr_decay=max(1, int(ep * 0.58)),
                    lr_decay_step=max(1, int(ep * 0.16)))
    tr = s.results["train_b128"]
    s.phase_profile("b128")
    update_launches = tr["profile"]["launches_per_update"]
    torch.cuda.synchronize()
    kernels.reset_launches()
    s.phase_product()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    s.phase_report()
    wall = time.perf_counter() - t_phase
    r = s.results
    if not (tr["killed_and_resumed"] and tr["resumed_from_update"] >= SOAK_REPORT
            and (tr["first_resumed_update"] or 0) > tr["resumed_from_update"]):
        fail(f"soak: kill and continue: {json.dumps({k: v for k, v in tr.items() if k != 'trajectory'})}")
    if tr["trajectory"][-1]["updates"] != SOAK_UPDATES or not all(
            math.isfinite(row["loss"]) for row in tr["trajectory"]):
        fail(f"soak: trajectory {tr['trajectory']}")
    with open(os.path.join(REPO, "SOAK_RESULTS.json")) as f:
        want = json.load(f)
    want.pop("train_b32", None)
    missing = missing_keys(want, r)
    if missing:
        fail(f"soak: RESULTS.json lacks the JAX soak's keys {missing}")
    prod, st = r["product"], r["product"]["streaming"]
    wers = [prod["viterbi_test_wer"], prod["beam_nolm_test_wer"], prod["beam_lm_test_wer"],
            st["streaming_wer"], st["offline_wer"], prod["topk_vs_full"]["topk_wer"],
            prod["topk_vs_full"]["full_wer"]]
    if not all(isinstance(w, float) and math.isfinite(w) for w in wers):
        fail(f"soak: WERs {wers}")
    if st["max_abs_stream_vs_batch_on_stream_features"] > STREAM_EM_TOL:
        fail(f"soak: streamed emissions {st['max_abs_stream_vs_batch_on_stream_features']} "
             f"from the batch network on the same features (tolerance {STREAM_EM_TOL})")
    if update_launches != expected_launches(FLAGSHIP, 1, 0):
        fail(f"soak: one update launched {update_launches}, expected "
             f"{expected_launches(FLAGSHIP, 1, 0)}")
    if not all(launches[k] for k in ("mfsc", "time_conv", "residual_ln")) or any(
            launches[k] for k in ("time_conv_wgrad", "residual_ln_bwd", "mhsa", "mhsa_bwd")):
        fail(f"soak: the chain's launches {launches} (forwards only: K1, K2, K3)")
    out = dict(results=r, launches=launches, update_launches=update_launches, wall_s=wall,
               budget_s=SOAK_WALL_S, corpus=dict(s.paths, lm=os.path.join(s.root, "lm3.arpa")))
    for step, sec in r["timing"].items():
        log(f"[soak step] {step}: {sec:.2f} s")
    log(f"[soak] {json.dumps(dict(train=dict((k, v) for k, v in tr.items() if k != 'trajectory'), product=prod, launches=launches))}")
    log(f"[soak] phase 13 in {wall:.1f} s (budget {SOAK_WALL_S} s) | {smi_line}")
    return out


# ---------------------------------------------------------------------------
# phases 14 and 15: ASG (conv_glu) and the residual recipe (resnet_ctc)
# ---------------------------------------------------------------------------
GLU_ARCH = os.path.join(REPO, "recipes", "conv_glu", "network.arch")
RES_ARCH = os.path.join(REPO, "recipes", "resnet_ctc", "network.arch")
# phase 13's corpus, cut to its shortest utterances: conv_glu's frames are
# the input's plus 222, and every frame is a step of ASG's loops
ASG_TRAIN_UTTS, ASG_TEST_UTTS = 16, 8
ASG_UPDATES = {"float32": 2, "bfloat16": 2}
RES_TRAIN_UTTS, RES_MAX_DURATION_S = 24, 60.0
RES_UPDATES = {"float32": 3, "bfloat16": 3}
# first batch, card against CPU, fp32: loss relative, each leaf's L2 error
# relative (``_leaf_errors``); and the relative nudge of the CPU's features
# that measures a gradient's fp32 conditioning (``card_vs_cpu_first_batch``)
CARD_CPU_TOL = (1e-4, 2e-3)
CONDITIONING = 1e-7
ASG_FN_TOL = 1e-4  # ASG loss, its gradients, path scores: card against CPU


def shortest(src, dst, n):
    """The ``n`` shortest utterances of list ``src`` written to ``dst``;
    returns (dst, their audio seconds)."""
    with open(src) as f:
        rows = sorted((float(line.split()[2]), line) for line in f if line.strip())[:n]
    with open(dst, "w") as f:
        f.writelines(line for _, line in rows)
    return dst, sum(d for d, _ in rows) / 1000.0


def card_launches(what, expect=None):
    """Fails unless the last run launched ``expect`` ({kernel: launches}, the
    rest 0) or, by default, K1 and no other kernel: the ASG and ResNet
    recipes' convs are weight-normed or wider than K2 takes (``F.conv2d``),
    their LayerNorms plain and they hold no attention."""
    from wav2letter_tpu_torch import kernels

    launches = dict(kernels.LAUNCHES)
    if expect is not None:
        want = {k: expect.get(k, 0) for k in launches}
        if launches != want:
            fail(f"{what}: launches {launches}, expected {want}")
    elif not launches["mfsc"] or any(v for k, v in launches.items() if k != "mfsc"):
        fail(f"{what}: launches {launches}, expected K1 alone")
    return launches


def _scalar_masses(model):
    """Hooks that record, for each scalar parameter (a LayerNorm's affine, a
    one-weight PReLU), the L1 mass of the terms its gradient sums: over every
    element of the activation, so that sum cancels far below its terms."""
    from wav2letter_tpu_torch.models.layers import LayerNorm, PReLU

    masses, handles = {}, []
    for name, mod in model.named_modules():
        if isinstance(mod, LayerNorm):
            def bwd(m, gin, gout, name=name):
                g = gout[0].detach().float()
                y = (m.saved.float() - m.bias.detach()) / m.weight.detach()
                masses[name + ".bias"] = g.abs().sum().item()
                masses[name + ".weight"] = (g * y).abs().sum().item()
        elif isinstance(mod, PReLU) and mod.weight.numel() == 1:
            def bwd(m, gin, gout, name=name):
                x = m.saved.float()
                masses[name + ".weight"] = (gout[0].detach().float() * x * (x < 0)).abs() \
                    .sum().item()
        else:
            continue

        def keep(m, inp, out):
            m.saved = (out if isinstance(m, LayerNorm) else inp[0]).detach()

        handles += [mod.register_forward_hook(keep), mod.register_full_backward_hook(bwd)]
    return masses, handles


def _loss_and_grads(tr, b, masses=None):
    """Loss and the gradient of every leaf (model and criterion) of one batch,
    the modules in eval mode (dropout off), autograd on; and the emission T.
    With ``masses`` (a dict), the scalar leaves' masses go into it."""
    import torch

    named = list(tr.model.named_parameters()) + [
        ("criterion." + n, p) for n, p in tr.criterion.named_parameters()]
    tr.model.eval()
    tr.criterion.eval()
    for _, p in named:
        p.grad = None
    handles = []
    if masses is not None:
        found, handles = _scalar_masses(tr.model)
    loss, em, _ = tr._loss(b, train=False)
    loss.backward()
    for h in handles:
        h.remove()
    if masses is not None:
        masses.update(found)
    # a leaf no loss reads (the mls plugin's LID head) has no gradient: JAX's 0
    return loss.item(), {n: (p.grad.detach().float().cpu() if p.grad is not None
                             else torch.zeros(p.shape)) for n, p in named}, em.shape[1]


def _leaf_errors(got, ref, masses):
    """Each leaf's L2 error relative to its norm, but not to less than 1% of
    the whole gradient's (a leaf whose true gradient is ~0 holds rounding) nor,
    for a scalar leaf, to less than the mass of the terms it sums."""
    import torch

    total = torch.sqrt(sum(g.pow(2).sum() for g in ref.values())).item()
    return {k: (got[k] - g).norm().item() / max(g.norm().item(), 0.01 * total,
                                                masses.get(k, 0.0))
            for k, g in ref.items()}


def card_vs_cpu_first_batch(name, flags, expect=None, dtypes=("float32", "bfloat16")):
    """The first training batch's loss and gradients (every leaf, the ASG
    transitions included) on the card (K1, ``F.conv2d``, cuBLAS) in fp32 and
    bf16 against the same model and batch on the CPU in fp32 (the plain
    versions). fp32 is gated, bf16 reported: the loss within
    ``CARD_CPU_TOL[0]``, each leaf within ``CARD_CPU_TOL[1]`` (``_leaf_errors``)
    or, where a leaf is over that, within twice what the CPU's own gradient
    of that leaf moves when the features change by 1e-7 relative
    (``CONDITIONING``, measured and reported on an fp32 run where a leaf is
    over ``CARD_CPU_TOL[1]``): an fp32
    gradient cannot be held closer than its conditioning, whatever computes
    it."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data.batching import pad_batch_rows
    from wav2letter_tpu_torch.features import FeatureParams, Featurizer
    from wav2letter_tpu_torch.runtime.train import Trainer

    res, ref, masses = {}, None, {}
    for dt in dtypes:
        cfg = Config.from_sources(argv=[f"--{k}={v}" for k, v in flags.items()])
        cfg.update(dict(rundir="", runname="", compute_dtype=dt))
        tr = Trainer(cfg, device="cuda")
        first = tr.train_ds.batch_specs(shuffle_seed=cfg.seed + 1)[0]
        host = pad_batch_rows(tr.train_ds.materialize(first), 1)
        kernels.reset_launches()
        t0 = time.perf_counter()
        got = _loss_and_grads(tr, tr._to_device(host))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        card_launches(f"{name} {dt} first batch", expect)
        cpu_batch = {k: v.cpu() for k, v in tr._to_device(host).items()}
        if ref is None:  # same weights and batch on the CPU, fp32
            tr.model.cpu()
            tr.criterion.cpu()
            tr.featurizer = Featurizer(FeatureParams.from_config(cfg))
            tr.compute_dtype = torch.float32
            t0 = time.perf_counter()
            ref = _loss_and_grads(tr, cpu_batch, masses)
            res["cpu_s"] = time.perf_counter() - t0
        (kl, kg, T), (pl, pg, _) = got, ref
        errs = _leaf_errors(kg, pg, masses)
        worst = sorted(errs, key=errs.get, reverse=True)
        cmp = dict(loss_card=kl, loss_cpu=pl, loss_rel_err=abs(kl - pl) / abs(pl),
                   batch=list(host["audio"].shape), T=T, n_leaves=len(pg),
                   worst_leaves=[dict(name=k, rel_l2=errs[k]) for k in worst[:3]],
                   criterion_rel_l2={k: errs[k] for k in pg if k.startswith("criterion.")},
                   gated=dt == "float32", card_s=card_s)
        over = [k for k in worst if errs[k] > CARD_CPU_TOL[1]]
        cmp["conditioning"] = None
        if dt == "float32" and over:  # the gradient's fp32 conditioning, on the CPU
            feats = tr.featurizer
            gen = torch.Generator().manual_seed(0)

            def nudged(audio, audio_len):
                f, flen = feats(audio, audio_len)
                return f * (1 + CONDITIONING * torch.randn(f.shape, generator=gen)), flen

            tr.featurizer = nudged
            sens = _leaf_errors(_loss_and_grads(tr, cpu_batch)[1], pg, masses)
            tr.featurizer = feats
            most = max(sens, key=sens.get)
            cmp["conditioning"] = dict(
                worst_nudged=dict(name=most, rel_l2=sens[most]), over_tol=len(over),
                over={k: dict(card=errs[k], cpu_nudged=sens[k]) for k in over[:5]})
            over = [k for k in over if errs[k] > 2 * sens[k]]
            cmp["conditioning"]["over_twice_conditioning"] = over
        cmp["ok"] = bool(math.isfinite(kl) and cmp["loss_rel_err"] <= CARD_CPU_TOL[0]
                         and not over)
        res[dt] = cmp
        log(f"[{name} first batch {dt}] {json.dumps(cmp)}")
        del tr
        torch.cuda.empty_cache()
    if not res["float32"]["ok"]:
        fail(f"{name}: the first batch's fp32 loss or gradients on the card differ from the "
             f"CPU: {json.dumps(res['float32'])}")
    return res


class _Calls:
    """Patches methods (``(class, name)`` pairs) for the run inside: each
    call's name, wall end (drained), launches on the card, loss and
    finiteness where the method returns them first, its object, and what
    ``extra(obj, *args)`` reads before the call."""

    def __init__(self, *targets, extra=None):
        self.targets, self.extra, self.calls = targets, extra, []

    def __enter__(self):
        import torch

        from wav2letter_tpu_torch import kernels

        self.saved = []
        calls = self.calls
        for cls, name in self.targets:
            orig = getattr(cls, name)
            self.saved.append((cls, name, orig, name in cls.__dict__))

            def wrapped(obj, *a, _orig=orig, _name=name, **kw):
                more = self.extra(obj, *a) if self.extra else {}
                before = dict(kernels.LAUNCHES)
                out = _orig(obj, *a, **kw)
                torch.cuda.synchronize()
                head = out[:2] if isinstance(out, tuple) and isinstance(out[0], float) \
                    else (None, None)
                calls.append(dict(name=_name, end=time.perf_counter(), loss=head[0],
                                  finite=head[1], obj=obj,
                                  launches={k: v - before[k]
                                            for k, v in kernels.LAUNCHES.items()}, **more))
                return out

            setattr(cls, name, wrapped)
        return self

    def __exit__(self, *exc):
        for cls, name, orig, own in reversed(self.saved):
            if own:
                setattr(cls, name, orig)
            else:
                delattr(cls, name)

    def held(self, what, expect):
        """Fails unless every call launched what ``expect[its name]`` says
        (and nothing else) and every loss is finite; returns the launches by
        kernel summed over the calls, and the calls by name."""
        from wav2letter_tpu_torch import kernels

        total = {k: 0 for k in kernels.LAUNCHES}
        for c in self.calls:
            want = {k: expect[c["name"]].get(k, 0) for k in kernels.LAUNCHES}
            if c["launches"] != want:
                fail(f"{what}: a {c['name']} launched {c['launches']}, expected {want}")
            if c["loss"] is not None and not (c["finite"] and math.isfinite(c["loss"])):
                fail(f"{what}: a {c['name']} gave loss {c['loss']} (finite {c['finite']})")
            for k, v in c["launches"].items():
                total[k] += v
        names = {}
        for c in self.calls:
            names[c["name"]] = names.get(c["name"], 0) + 1
        return total, names


def _train_steps():
    """``_Calls`` on ``Trainer.train_step``, for the trainers ``cli.train``
    builds: each update also with its frames and the seq2seq attention
    window's gate."""
    from wav2letter_tpu_torch.runtime.train import Trainer

    return _Calls((Trainer, "train_step"), extra=lambda tr, batch, *a: dict(
        frames=int(batch["audio"].shape[1]), window=tr._window_active()))


def update_numbers(tr, batch):
    """One more update of a trained ``Trainer`` at learning rate 0: its wall
    time (drained), then one under the profiler: device busy time, idle share,
    launches on the card; peak memory of the two."""
    return dict(batch=list(batch["audio"].shape),
                **step_numbers(lambda: tr.train_step(batch, 0.0, 0.0, False, 12345)))


def step_numbers(fn):
    """``fn()`` (one step) timed on the wall (drained), then once more under
    the profiler: device busy time, idle share, launches on the card; the peak
    memory of the two."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = list(device_events(profile_device(fn)))
    busy = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:5]
    return dict(wall_ms=wall_ms, device_busy_ms=busy, idle_share=1 - busy / wall_ms,
                device_launches=sum(e.count for e in events),
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                top_kernels_ms={e.key[:80]: e.self_device_time_total / 1e3 for e in top})


def criterion_share(tr, batch):
    """The criterion's part of an update on ``batch``: its forward and its
    backward alone on the update's emissions, and the train-time Viterbi (a
    seq2seq criterion's greedy decode): host wall ms (drained), device ms and
    launches on the card each, T and U."""
    import torch

    b = tr._to_device(batch)
    with torch.no_grad():
        feats, flen = tr.featurizer(b["audio"], b["audio_len"])
        em, elen = tr.model(feats.to(tr.compute_dtype), flen)
    em = em.float().detach().requires_grad_(True)
    out, loss = {}, []

    def part(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof = profile_device(fn)
        events = list(device_events(prof))
        out[name] = dict(wall_ms=wall, device_ms=sum(e.self_device_time_total
                                                     for e in events) / 1e3,
                         launches=sum(e.count for e in events))

    def fwd():
        loss[:] = [(tr.criterion(em, b["target"], elen, b["target_len"])
                    * b["row_mask"]).sum()]

    part("forward", fwd)
    part("backward", lambda: loss[0].backward(retain_graph=True))
    with torch.no_grad():
        part("viterbi", lambda: tr._viterbi(em, elen))
    out["T"] = int(em.shape[1])
    out["B"] = int(em.shape[0])
    out["U"] = int(b["target"].shape[1])
    return out


def trained_runs(name, flags, updates, smi_line, share=False, expect=None):
    """``cli.train`` at each type for ``updates[type]`` updates (K1 alone on
    the card, or ``expect`` an update, every loss finite), a checkpoint each;
    in the first type, numbers of one more update and, with ``share``, of the
    criterion's part of it (the criterion runs in fp32 whatever the type)."""
    import torch

    from wav2letter_tpu_torch.cli.train import main as train_main
    from wav2letter_tpu_torch.data.batching import pad_batch_rows
    from wav2letter_tpu_torch import kernels

    results = {}
    for dt, n in updates.items():
        argv = ["train"] + [f"--{k}={v}" for k, v in flags.items()] + [
            f"--compute_dtype={dt}", f"--runname={name}_{dt}", f"--iter={n}",
            f"--reportiters={n}"]
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _train_steps() as rec:
            tr = train_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = card_launches(f"{name} {dt} training",
                                 None if expect is None else {k: v * n for k, v in expect.items()})
        steps = rec.calls
        if len(steps) != n or not all(s["finite"] and math.isfinite(s["loss"]) for s in steps):
            fail(f"{name} {dt}: {len(steps)} updates, {[(s['loss'], s['finite']) for s in steps]}")
        if any(s["launches"]["mfsc"] != 1 for s in steps):
            fail(f"{name} {dt}: an update launched K1 other than once: "
                 f"{[st['launches'] for st in steps]}")
        span = steps[-1]["end"] - steps[0]["end"]
        largest = max(tr.train_ds.batch_specs(), key=lambda sp: sp.max_input_frames)
        batch = pad_batch_rows(tr.train_ds.materialize(largest), 1)
        res = dict(updates=n, losses=[s["loss"] for s in steps],
                   frames=[s["frames"] for s in steps], windows=[s["window"] for s in steps],
                   wall_s=wall,
                   s_per_update=span / (n - 1) if n > 1 else None, launches=launches,
                   peak_mem_gib_training=torch.cuda.max_memory_allocated() / 2**30,
                   nvidia_smi=smi_line)
        if not results:
            res["update"] = update_numbers(tr, batch)
            if share:
                res["criterion"] = criterion_share(tr, batch)
        results[dt] = res
        log(f"[{name} train {dt}] {json.dumps(res)}")
        del tr
        torch.cuda.empty_cache()
    return results


def align_words_in_order(align_path, lst, what):
    """Every utterance of ``lst`` has a line in the align file, and the words
    of its segments (``$`` left out; an ASG replabel ``<r>`` repeats the letter
    before it r more times) are the transcript's, in order."""
    with open(lst) as f:
        want = {line.split()[1]: line.split()[3:] for line in f if line.strip()}
    got = {}
    with open(align_path) as f:
        for line in f:
            audio, entries = line.rstrip("\n").split("\t", 1)
            words = [e.split(" ", 4)[4] for e in entries.split("\\n")]
            got[audio] = [re.sub(r"(.)<(\d+)>", lambda m: m.group(1) * (1 + int(m.group(2))), w)
                          for w in words if w != "$"]
    if got != want:
        bad = [a for a in want if got.get(a) != want[a]][:2]
        fail(f"{what}: align file words differ from the transcripts: "
             f"{[(a, got.get(a), want[a]) for a in bad]}")


def asg_functions_card_vs_cpu(am, lst):
    """On the trained model's emissions of the first batch of ``lst``: the
    card's ``asg_loss`` and its two gradients, ``asg_viterbi`` and
    ``asg_forced_align`` against the same functions on the CPU. A path may
    differ only where its max-product score is within ``ASG_FN_TOL``."""
    import numpy as np
    import torch

    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data import AsrDataset
    from wav2letter_tpu_torch.ops.align import asg_forced_align
    from wav2letter_tpu_torch.ops.asg import asg_loss, asg_viterbi
    from wav2letter_tpu_torch.runtime.test import Evaluator

    ev = Evaluator(Config(am=am, test=lst, batchsize=ASG_TEST_UTTS), device="cuda")
    ds = AsrDataset(lst, ev.token_dict, ev.lexicon, ev.cfg, batch_size=ASG_TEST_UTTS)
    batch = ds.materialize(ds.batch_specs()[0])
    em, elen = ev.emissions(batch)
    tgt = torch.from_numpy(np.asarray(batch["target"])).cuda()
    tl = torch.from_numpy(np.asarray(batch["target_len"])).cuda()
    sides = {}
    for dev in ("cuda", "cpu"):
        e = em.detach().to(dev).requires_grad_(True)
        tr_ = ev.transitions.detach().to(dev).requires_grad_(True)
        args = [a.to(dev) for a in (tgt, elen, tl)]
        loss = asg_loss(e, tr_, *args)
        loss.sum().backward()
        path = asg_viterbi(e.detach(), tr_.detach(), args[1])
        fpath, fscore = asg_forced_align(e.detach(), tr_.detach(), *args)
        sides[dev] = [t.detach().cpu() for t in (loss, e.grad, tr_.grad, path, fpath, fscore)]
    (lg, eg, tg, pg, fg, sg), (lc, ec, tc, pc, fc, sc) = sides["cuda"], sides["cpu"]
    emc, trc, elc = em.detach().cpu(), ev.transitions.cpu(), elen.cpu()

    def score(path):
        p = path.long()
        e = emc.gather(2, p[..., None])[..., 0]
        t = torch.arange(emc.shape[1])[None, :] < elc[:, None]
        return (e * t).sum(1) + (trc[p[:, 1:], p[:, :-1]] * t[:, 1:]).sum(1)

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()

    vdiff = (pg != pc).any(dim=1)
    fdiff = (fg != fc).any(dim=1)
    out = dict(B=int(em.shape[0]), T=int(em.shape[1]),
               loss_rel_err=((lg - lc).abs() / lc.abs()).max().item(),
               em_grad_rel_l2=rel(eg, ec), trans_grad_rel_l2=rel(tg, tc),
               viterbi_rows_differ=int(vdiff.sum()), forced_rows_differ=int(fdiff.sum()),
               viterbi_score_rel_err=(((score(pg) - score(pc)).abs() / score(pc).abs())[vdiff]
                                      .max().item() if vdiff.any() else 0.0),
               forced_score_rel_err=((sg - sc).abs() / sc.abs()).max().item())
    out["ok"] = all(out[k] <= ASG_FN_TOL for k in (
        "loss_rel_err", "em_grad_rel_l2", "trans_grad_rel_l2", "viterbi_score_rel_err",
        "forced_score_rel_err"))
    log(f"[asg functions card vs cpu] {json.dumps(out)}")
    if not out["ok"]:
        fail(f"ASG functions on the card differ from the CPU: {out}")
    return out


def serve_align(name, am, lst, secs, tmp, extra=(), decode_flags=None):
    """``cli.test``, ``cli.decode`` (when ``decode_flags``) and ``cli.align``
    on checkpoint ``am`` over ``lst``: each launches K1 alone; rates in audio
    s per wall s, align utterances per s; the align file's words in order."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.cli.align import main as align_main
    from wav2letter_tpu_torch.cli.decode import main as decode_main
    from wav2letter_tpu_torch.cli.test import main as test_main

    out = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = test_main([f"--am={am}", f"--test={lst}", "--batchsize=4", *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not math.isfinite(res["loss"]):
        fail(f"{name} cli.test: {res}")
    out["test"] = dict(res, wall_s=wall, audio_s_per_s=secs / wall,
                       launches=card_launches(f"{name} cli.test"))
    if decode_flags is not None:
        kernels.reset_launches()
        dres = decode_main([f"--am={am}", f"--test={lst}", "--batchsize=4",
                            f"--sclite={os.path.join(tmp, name + '_decode')}",
                            *[f"--{k}={v}" for k, v in decode_flags.items()]])
        torch.cuda.synchronize()
        if not (math.isfinite(dres["WER"]) and dres["decoder"] == "NativeBeamDecoder"):
            fail(f"{name} cli.decode: {dres}")
        out["decode"] = dict(dres, audio_s_per_s=secs / (dres["wall_s"] - dres["setup_s"]),
                             launches=card_launches(f"{name} cli.decode"))
    align_path = os.path.join(tmp, f"{name}.align")
    kernels.reset_launches()
    t0 = time.perf_counter()
    n = align_main([align_path, f"--am={am}", f"--test={lst}", "--batchsize=4"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    align_words_in_order(align_path, lst, f"{name} cli.align")
    out["align"] = dict(utterances=n, wall_s=wall, utts_per_s=n / wall,
                        launches=card_launches(f"{name} cli.align"))
    log(f"[{name} serve] {json.dumps(out)}")
    return out


def asg_path(tmp, corpus, smi_line):
    """Phase 14: ``recipes/conv_glu`` at full width with ASG, through the
    port's binaries, on phase 13's corpus (its shortest utterances) and LM."""
    import torch

    from wav2letter_tpu_torch.cli.train import main as train_main
    from wav2letter_tpu_torch.models import build_arch_module
    from wav2letter_tpu_torch.runtime.checkpoint import load_checkpoint

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "asg")
    os.makedirs(root, exist_ok=True)
    train_lst, _ = shortest(corpus["train"], os.path.join(root, "train.lst"), ASG_TRAIN_UTTS)
    test_lst, test_secs = shortest(corpus["test"], os.path.join(root, "test.lst"),
                                   ASG_TEST_UTTS)
    flags = dict(flagsfile=os.path.join(REPO, "recipes", "conv_glu", "train.cfg"),
                 arch=GLU_ARCH, train=train_lst, tokens=corpus["tokens"],
                 lexicon=corpus["lexicon"], rundir=os.path.join(root, "runs"), nthread=2,
                 seed=0)
    n_classes = 21 + 2  # "|" + 20 letters, then the replabels <1>, <2>
    with torch.device("meta"):
        n_params = sum(p.numel() for p in build_arch_module(GLU_ARCH, 40, n_classes).parameters())
    log(f"[conv_glu] {n_params} parameters (+ {n_classes}^2 transitions) | {smi_line}")
    laps = {}
    first = card_vs_cpu_first_batch("conv_glu", flags)
    laps["first_batch"] = time.perf_counter() - t_phase
    runs = trained_runs("conv_glu", flags, ASG_UPDATES, smi_line)
    laps["train"] = time.perf_counter() - t_phase
    # continue the bf16 run by 1 update through the binary
    rundir, run = flags["rundir"], "conv_glu_bfloat16"
    n0 = ASG_UPDATES["bfloat16"]
    tr = train_main(["continue", f"--rundir={rundir}", f"--runname={run}",
                     f"--iter={n0 + 1}", f"--reportiters={n0 + 1}"])
    last = os.path.join(rundir, run, "model_last.bin")
    ckpt = load_checkpoint(last)
    trans = tr.criterion.transitions.detach().cpu()
    eye = 4.0 * torch.eye(n_classes)
    if (tr.updates, ckpt.updates, tr.skipped) != (n0 + 1, n0 + 1, 0) \
            or not torch.equal(ckpt.crit_state_dict["transitions"], trans) \
            or torch.equal(trans, eye):
        fail(f"conv_glu continue: updates {tr.updates}/{ckpt.updates}, skipped {tr.skipped}, "
             f"transitions moved {(trans - eye).abs().max().item()} from transdiag*I, "
             "stored equal: " + str(torch.equal(ckpt.crit_state_dict["transitions"], trans)))
    del tr
    torch.cuda.empty_cache()
    laps["continue"] = time.perf_counter() - t_phase
    fns = asg_functions_card_vs_cpu(last, test_lst)
    laps["functions"] = time.perf_counter() - t_phase
    decode = dict(lm=corpus["lm"], lmweight=1.0, wordscore=1.0, silscore=-0.5,
                  beamsize=100, beamthreshold=25, smearing="max", nthread_decoder=4,
                  uselexicon=True, decodertype="wrd")
    served = serve_align("conv_glu", last, test_lst, test_secs, root, decode_flags=decode)
    out = dict(n_params=n_params, first_batch=first, training=runs, functions=fns,
               transitions_moved=(trans - eye).abs().max().item(), served=served,
               phase_s=time.perf_counter() - t_phase, laps_s=laps, nvidia_smi=smi_line)
    log(f"[conv_glu] phase 14 in {out['phase_s']:.1f} s (laps {json.dumps(laps)}) | {smi_line}")
    return out


def resnet_path(tmp, corpus, smi_line):
    """Phase 15: ``recipes/resnet_ctc`` at full width with CTC and dynamic
    batching, on phase 13's corpus (letters, not the recipe's word pieces)."""
    import torch

    from wav2letter_tpu_torch.models import build_arch_module

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "resnet")
    os.makedirs(root, exist_ok=True)
    train_lst, _ = shortest(corpus["train"], os.path.join(root, "train.lst"), RES_TRAIN_UTTS)
    test_lst, test_secs = shortest(corpus["test"], os.path.join(root, "test.lst"),
                                   ASG_TEST_UTTS)
    flags = dict(arch=RES_ARCH, train=train_lst, tokens=corpus["tokens"],
                 lexicon=corpus["lexicon"], rundir=os.path.join(root, "runs"),
                 criterion="ctc", mfsc=True, filterbanks=80, batchsize=16,
                 batching_strategy="dynamic", batching_max_duration=RES_MAX_DURATION_S,
                 lr=0.4, netoptim="sgd", momentum=0.6, maxgradnorm=1.0, onorm="target",
                 sqnorm=True, saug_start_update=16000, nthread=2, seed=0)
    n_classes = 21 + 1  # "|" + 20 letters, then the blank
    with torch.device("meta"):
        n_params = sum(p.numel() for p in build_arch_module(RES_ARCH, 80, n_classes).parameters())
    log(f"[resnet_ctc] {n_params} parameters | {smi_line}")
    laps = {}
    first = card_vs_cpu_first_batch("resnet_ctc", flags)
    laps["first_batch"] = time.perf_counter() - t_phase
    runs = trained_runs("resnet_ctc", flags, RES_UPDATES, smi_line)
    laps["train"] = time.perf_counter() - t_phase
    last = os.path.join(flags["rundir"], "resnet_ctc_float32", "model_last.bin")
    served = serve_align("resnet_ctc", last, test_lst, test_secs, root)
    out = dict(n_params=n_params, first_batch=first, training=runs, served=served,
               phase_s=time.perf_counter() - t_phase, laps_s=laps, nvidia_smi=smi_line)
    log(f"[resnet_ctc] phase 15 in {out['phase_s']:.1f} s (laps {json.dumps(laps)}) | "
        f"{smi_line}")
    return out

# ---------------------------------------------------------------------------
# phases 16 and 17: the attention seq2seq recipes
# ---------------------------------------------------------------------------
S2S_TRAIN_UTTS, S2S_TEST_UTTS = 16, 4
S2S_UPDATES = {"float32": 2, "bfloat16": 2}
# phase 13's corpus is letters (no word pieces): the recipes' word-piece
# flags give way to the corpus' separator
S2S_LETTERS = dict(usewordpiece=False, wordseparator="|")
# recipes/seq2seq_tds/README.md's beam (80 wide, eos score, attention
# threshold, hard and soft selection) with the lexicon and phase 13's 3-gram
S2S_DECODE = dict(uselexicon=True, decodertype="wrd", beamsize=80, eosscore=-1.0,
                  attentionthreshold=30, hardselection=1.5, softselection=10.0,
                  lmweight=1.0, wordscore=1.0, nthread_decoder=1)
# per forward and what an update adds: seq2seq_tds has 3 C2 and 11 TDS convs
# (the first takes the features: no dgrad); its TDS blocks normalize over time
# (the arch's default), which K3's per-frame fusion does not compute, so no K3;
# transformer_s2s's convs are weight-normed (F.conv2d), its 12 TR layers take
# K4 and two K3 each
S2S_RECIPES = {
    "seq2seq_tds": dict(
        phase=16, flags=dict(encoderdim=512),
        per_forward={"mfsc": 1, "time_conv": 14},
        per_backward={"time_conv": 13, "time_conv_wgrad": 14}),
    "transformer_s2s": dict(
        phase=17, flags={}, updates={"float32": 2, "bfloat16": 1},
        per_forward={"mfsc": 1, "mhsa": 12, "residual_ln": 24},
        per_backward={"mhsa_bwd": 12, "residual_ln_bwd": 24}),
}
S2S_LOGIT_TOL = 1e-4  # teacher-forced logits, card against CPU, relative to the largest
S2S_TIE = 1e-3  # top-2 margin of the CPU's logits within which greedy tokens may part
S2S_BEAM_TOL = 1e-4  # native against Python beam scores, and the KV cache's logits


def s2s_kernel_rows(name, spec, train_lst, corpus, details):
    """The path's kernels at the largest training batch's shapes against
    their plain versions, fp32 and bf16: seq2seq_tds's K2, dgrad, K2b at C =
    10, 14, 18 (timed with their library calls); transformer_s2s's K4, K4b
    (12 calls, T after the three pools; timed once by events) and K3, K3b at
    768."""
    import torch

    from wav2letter_tpu_torch.models import build_arch_module

    B = 16 if name == "seq2seq_tds" else 8
    _, T, _ = batch_shapes(train_lst, corpus["tokens"], corpus["lexicon"], B)
    rows = []
    for dt in ("float32", "bfloat16"):
        if name == "seq2seq_tds":
            with torch.device("meta"):
                model = build_arch_module(spec["arch"], N_FEAT, 512, force_label_dim=False)
            convs, _ = path_calls(model, B, T)
            rows += check_time_conv(convs, dt, details, time_plain=False)
            back = check_time_conv_backward(convs, dt, details, time_plain=False)
            rows += back["time_conv_dgrad"] + back["time_conv_wgrad"]
        else:
            Ta = pooled_frames(T)
            att = check_attention([("s2s_train", B, Ta, 4, 192, True, 12)], dt, details)
            lns = [(B * Ta, 768)] * 24
            rows += att["mhsa"] + att["mhsa_bwd"] + check_residual_ln(lns, dt, details)
            rows += check_residual_ln_bwd(lns, dt, details)
        torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{name}: {len(bad)} kernel checks disagree with the plain versions: "
             f"{json.dumps(bad[0])}")
    return [dict(name=r["name"], dtype=r["dtype"], shape=r["shape"], calls=r["calls"],
                 ms=r["ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                 bound_ms=r["bound_ms"], max_abs_err=r["max_abs_err"]) for r in rows]


def s2s_decoder_card_vs_cpu(name, am, lst):
    """On the trained model's encoder states of ``lst``'s first batch: the
    decoder's teacher-forced logits on the card against a CPU copy, and the
    card's greedy tokens against the CPU's step by step: a row may part only at
    a step whose top-2 margin on the CPU is within ``S2S_TIE`` (counted); for
    the transformer, the KV-cached step against the full decoder on the card.
    Returns the result and the Evaluator, for the beams."""
    import copy

    import numpy as np
    import torch

    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data import AsrDataset
    from wav2letter_tpu_torch.runtime.test import Evaluator

    ev = Evaluator(Config(am=am, test=lst, batchsize=S2S_TEST_UTTS), device="cuda")
    ds = AsrDataset(lst, ev.token_dict, ev.lexicon, ev.cfg, batch_size=S2S_TEST_UTTS)
    batch = ds.materialize(ds.batch_specs()[0])
    em, elen = ev.emissions(batch)
    crit, cpu = ev.s2s_criterion, copy.deepcopy(ev.s2s_criterion).cpu()
    tgt = torch.from_numpy(np.asarray(batch["target"]))
    with torch.no_grad():
        got = crit.teacher_forced(em, tgt.cuda(), elen, train=False)[0].cpu()
        want = cpu.teacher_forced(em.cpu(), tgt, elen.cpu(), train=False)[0]
        scale = want.abs().max().item()
        logit_err = (got - want).abs().max().item() / scale
        toks, lens = (t.cpu() for t in crit.greedy_path(em, elen))
        # the CPU's greedy steps on the card's tokens, with their margins
        c = cpu.cfg
        B, T = em.shape[:2]
        mask = torch.arange(T)[None, :] < elen.cpu()[:, None]
        state, prev = cpu.init_state(B), torch.full((B,), c.eos_idx)
        parted, ties, compared = [None] * B, 0, 0
        for u in range(int(lens.max()) + 1 if lens.numel() else 0):
            state, lg = cpu.decode_step(state, prev, em.cpu(), mask, u)
            top2 = lg.topk(2, dim=-1)
            for i in range(B):
                if parted[i] is None and u <= int(lens[i]) and u < toks.shape[1]:
                    compared += 1
                    if int(top2.indices[i, 0]) != int(toks[i, u]):
                        margin = (top2.values[i, 0] - lg[i, int(toks[i, u])]).item()
                        parted[i] = margin
                        if margin > S2S_TIE:
                            fail(f"{name}: greedy token {u} of row {i}: card "
                                 f"{int(toks[i, u])}, CPU {int(top2.indices[i, 0])}, "
                                 f"margin {margin}")
                        ties += 1
            prev = toks[:, u].long() if u < toks.shape[1] else prev
        out = dict(B=B, T=T, U=int(tgt.shape[1]), logit_rel_err=logit_err,
                   greedy_steps_compared=compared, greedy_ties=ties,
                   greedy_lengths=lens.tolist())
        if hasattr(crit, "_decode_all"):  # the KV cache against the full decoder
            dec_in = torch.cat([torch.full((B, 1), c.eos_idx), tgt.clamp(min=0).long()], 1).cuda()
            emask = mask.cuda()
            full = crit._decode_all(dec_in, em, emask)
            st, steps = crit.init_state(B), []
            for u in range(dec_in.shape[1]):
                st, lg = crit.decode_step(st, dec_in[:, u], em, emask, u)
                steps.append(lg)
            out["kv_cache_rel_err"] = ((torch.stack(steps, 1) - full).abs().max()
                                       / full.abs().max()).item()
    out["ok"] = logit_err <= S2S_LOGIT_TOL and out.get("kv_cache_rel_err", 0) <= S2S_BEAM_TOL
    log(f"[{name} decoder card vs cpu] {json.dumps(out)}")
    if not out["ok"]:
        fail(f"{name}: the decoder on the card differs from the CPU: {out}")
    return out, ev, em, elen


def s2s_beams(name, ev, em, elen, lm, smi_line):
    """For seq2seq_tds, the native beam against the Python beam (both on the
    card's decoder step) on the two shortest utterances of the batch: the
    same 4-best (tokens, words), scores within ``S2S_BEAM_TOL``, some
    hypothesis with tokens (the transformer's beams are held to each other,
    batched against sequential, in ``s2s_serve``). The attention threshold is left out here: a decoder of a few
    updates attends nowhere in particular, and a threshold of 30 frames
    prunes every hypothesis at the first step. And one decoder step at K =
    80: wall and device ms."""
    import numpy as np
    import torch

    from wav2letter_tpu_torch.decoder.seq2seq_beam import _gather_state, make_s2s_update_fn
    from wav2letter_tpu_torch.runtime.decode import S2SBeamParts

    cfg = ev.cfg
    cfg.update(dict(S2S_DECODE, lm=lm, attentionthreshold=math.inf))
    eos, L = ev.n_classes - 2, cfg.maxdecoderoutputlen
    order = torch.argsort(elen.cpu())[:2].tolist()
    ems = [em[i, : int(elen[i])].cpu().numpy() for i in order]
    out = {}
    for native in (True, False) if name == "seq2seq_tds" else (True,):
        parts = S2SBeamParts(cfg, ev.token_dict, ev.lexicon, use_native=native)
        t0 = time.perf_counter()
        res = [parts.decoder(ev.s2s_criterion, e, eos, L).decode(n_best=4) for e in ems]
        out["native" if native else "python"] = (res, time.perf_counter() - t0)
    nres, n_s = out["native"]
    pres, p_s = out.get("python", (nres, None))
    for a, b in zip(nres, pres):
        if [(r.tokens, r.words) for r in a] != [(r.tokens, r.words) for r in b] or any(
                abs(x.score - y.score) > S2S_BEAM_TOL * max(1.0, abs(y.score))
                for x, y in zip(a, b)):
            fail(f"{name}: native and Python beams differ: "
                 f"{[(r.tokens, r.score) for r in a]} against {[(r.tokens, r.score) for r in b]}")
    if not any(r.tokens for rs in nres for r in rs):
        fail(f"{name}: the beams kept no hypothesis with tokens: {nres}")
    # one step of the decoder at K = 80 hypotheses, state gathered as a beam does
    e = ems[-1]
    step, init = make_s2s_update_fn(ev.s2s_criterion, e, e.shape[0])
    K = S2S_DECODE["beamsize"]
    toks = np.arange(K, dtype=np.int32) % (ev.n_classes - 2)
    state, _, _ = step(init(K), toks)
    rows = np.arange(K)[::-1].copy()

    def one():
        step(_gather_state(state, rows), toks)

    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        one()
    wall = (time.perf_counter() - t0) / 10 * 1e3
    events = list(device_events(profile_device(one)))
    res = dict(utterances=len(ems), frames=[x.shape[0] for x in ems],
               nbest_tokens=[[len(r.tokens) for r in rs] for rs in nres], native_s=n_s,
               python_s=p_s,
               step_k80=dict(wall_ms=wall,
                             device_ms=sum(ev_.self_device_time_total for ev_ in events) / 1e3,
                             launches=sum(ev_.count for ev_ in events), T=int(e.shape[0])),
               nvidia_smi=smi_line)
    log(f"[{name} beams] {json.dumps(res)}")
    return res


def s2s_serve(name, spec, am, lst, secs, tmp, lm):
    """``cli.test`` (greedy), then ``cli.decode`` (native lexicon beam, the LM,
    ``W2L_REQUIRE_NATIVE=1``) sequentially with the README's flags and: for
    seq2seq_tds without the attention threshold (which prunes a barely
    trained decoder's every hypothesis at once, so that decode times nothing),
    for the transformer (no attention peaks) with ``--s2s_batch_decode=4``,
    whose hypotheses must equal the sequential ones. Launches: the forwards'
    alone; rates in audio s per wall s."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.cli.decode import main as decode_main
    from wav2letter_tpu_torch.cli.test import main as test_main

    n_batches = -(-S2S_TEST_UTTS // 4)
    fwd = expected_launches(spec, 0, n_batches)
    out = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = test_main([f"--am={am}", f"--test={lst}", "--batchsize=4"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not math.isfinite(res["loss"]):
        fail(f"{name} cli.test: {res}")
    out["test"] = dict(res, wall_s=wall, audio_s_per_s=secs / wall,
                       launches=card_launches(f"{name} cli.test", fwd))
    os.environ["W2L_REQUIRE_NATIVE"] = "1"
    hyps = {}
    second = (("decode_batched", {"s2s_batch_decode": 4}) if name == "transformer_s2s"
              else ("decode_no_threshold", {"attentionthreshold": "inf"}))
    for how, extra in (("decode", {}), second):
        kernels.reset_launches()
        sclite = os.path.join(tmp, f"{name}_{how}")
        dres = decode_main([f"--am={am}", f"--test={lst}", "--batchsize=4",
                            f"--sclite={sclite}", f"--lm={lm}",
                            *[f"--{k}={v}" for k, v in dict(S2S_DECODE, **extra).items()]])
        torch.cuda.synchronize()
        want = "NativeSeq2SeqBatchDecoder" if how == "decode_batched" else "NativeSeq2SeqDecoder"
        if not (math.isfinite(dres["WER"]) and dres["decoder"] == want):
            fail(f"{name} cli.{how}: {dres}")
        hyps[how] = read_hyps(sclite, lst)
        out[how] = dict(dres, audio_s_per_s=secs / (dres["wall_s"] - dres["setup_s"]),
                        launches=card_launches(f"{name} cli.{how}", fwd))
    if "decode_batched" in hyps and hyps["decode_batched"] != hyps["decode"]:
        fail(f"{name}: batched and sequential beams differ: {hyps}")
    log(f"[{name} serve] {json.dumps(out)}")
    return out


def s2s_path(name, tmp, corpus, smi_line):
    """Phase 16 (``recipes/seq2seq_tds``, GRU decoder, its ``train.cfg`` with
    ``--encoderdim=512``) or 17 (``recipes/transformer_s2s``, its
    ``train.cfg``) at full width through the port's binaries on phase 13's
    corpus (its shortest utterances; letters, not the recipes' word pieces):
    the first batch card against CPU, the path's kernels at its shapes,
    ``S2S_UPDATES`` fp32 and bf16 updates (or the recipe's own ``updates``)
    and ``continue`` for 2 (seq2seq_tds,
    across its window's switch) or 1 (the window's gate as the recipe sets it), the decoder card against CPU, the beams, then ``cli.test`` and
    ``cli.decode``."""
    import torch

    from wav2letter_tpu_torch.cli.train import main as train_main
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.criterions import make_criterion
    from wav2letter_tpu_torch.models import build_arch_module
    from wav2letter_tpu_torch.runtime.checkpoint import load_checkpoint

    spec = dict(S2S_RECIPES[name], arch=os.path.join(REPO, "recipes", name, "network.arch"))
    t_phase = time.perf_counter()
    root = os.path.join(tmp, name)
    os.makedirs(root, exist_ok=True)
    train_lst, _ = shortest(corpus["train"], os.path.join(root, "train.lst"), S2S_TRAIN_UTTS)
    test_lst, test_secs = shortest(corpus["test"], os.path.join(root, "test.lst"),
                                   S2S_TEST_UTTS)
    flags = dict(flagsfile=os.path.join(REPO, "recipes", name, "train.cfg"), arch=spec["arch"],
                 train=train_lst, tokens=corpus["tokens"], lexicon=corpus["lexicon"],
                 rundir=os.path.join(root, "runs"), nthread=2, seed=0, **S2S_LETTERS,
                 **spec["flags"])
    cfg = Config.from_sources(argv=[f"--{k}={v}" for k, v in flags.items()])
    n_classes = 21 + 2  # "|" + 20 letters, then eos and pad
    with torch.device("meta"):
        n_params = sum(p.numel() for p in build_arch_module(
            spec["arch"], N_FEAT, cfg.encoderdim, force_label_dim=False).parameters())
    n_crit = sum(p.numel() for p in make_criterion(cfg, n_classes).parameters())
    log(f"[{name}] phase {spec['phase']}: {n_params} encoder parameters, {n_crit} decoder "
        f"parameters | {smi_line}")
    laps = {}
    per_update = expected_launches(spec, 1, 0)
    first = card_vs_cpu_first_batch(name, flags, per_update, dtypes=("float32",))
    laps["first_batch"] = time.perf_counter() - t_phase
    kernel_rows = s2s_kernel_rows(name, spec, train_lst, corpus, [])
    laps["kernels"] = time.perf_counter() - t_phase
    # the criterion's share of an update: the GRU decoder's; the transformer
    # decoder's greedy decode (~42k launches) and, in phase 14, ASG's loops
    # (~35k) take too long to profile in the script's budget
    updates = spec.get("updates", S2S_UPDATES)
    runs = trained_runs(name, flags, updates, smi_line, share=name == "seq2seq_tds",
                        expect=per_update)
    laps["train"] = time.perf_counter() - t_phase
    windows = {dt: r["windows"] for dt, r in runs.items()}
    # continue the bf16 run through the binary: across the attention window's
    # switch where the recipe has one (seq2seq_tds's, at --pretrainWindow =
    # 3), else by one update
    n_cont = 1 if cfg.trainWithWindow else 2
    rundir, run = flags["rundir"], f"{name}_bfloat16"
    n0 = updates["bfloat16"]
    with _train_steps() as rec:
        tr = train_main(["continue", f"--rundir={rundir}", f"--runname={run}",
                         f"--iter={n0 + n_cont}", f"--reportiters={n0 + n_cont}"])
    last = os.path.join(rundir, run, "model_last.bin")
    ckpt = load_checkpoint(last)
    windows["continue"] = [st["window"] for st in rec.calls]
    # the window's gate as the recipe sets it: seq2seq_tds on while updates <
    # --pretrainWindow (3), transformer_s2s always on (--trainWithWindow)
    want = {k: [bool(cfg.trainWithWindow) or u < cfg.pretrainWindow for u in range(a, b)]
            for k, (a, b) in dict(float32=(0, updates["float32"]), bfloat16=(0, n0),
                                  **{"continue": (n0, n0 + n_cont)}).items()}
    if (tr.updates, ckpt.updates, tr.skipped) != (n0 + n_cont,) * 2 + (0,) \
            or windows != want or not all(math.isfinite(st["loss"]) for st in rec.calls):
        fail(f"{name} continue: updates {tr.updates}/{ckpt.updates}, skipped {tr.skipped}, "
             f"windows {windows}, losses {[st['loss'] for st in rec.calls]}")
    del tr
    torch.cuda.empty_cache()
    laps["continue"] = time.perf_counter() - t_phase
    decoder, ev, em, elen = s2s_decoder_card_vs_cpu(name, last, test_lst)
    beams = s2s_beams(name, ev, em, elen, corpus["lm"], smi_line)
    del ev, em
    torch.cuda.empty_cache()
    laps["decoder"] = time.perf_counter() - t_phase
    served = s2s_serve(name, spec, last, test_lst, test_secs, root, corpus["lm"])
    out = dict(n_params=n_params, n_decoder_params=n_crit, first_batch=first,
               kernels=kernel_rows, training=runs, windows=windows, decoder=decoder,
               beams=beams, served=served, phase_s=time.perf_counter() - t_phase, laps_s=laps,
               nvidia_smi=smi_line, am=last)
    log(f"[{name}] phase {spec['phase']} in {out['phase_s']:.1f} s (laps {json.dumps(laps)}) | "
        f"{smi_line}")
    return out


# ---------------------------------------------------------------------------
# phase 18: the language-model slice
# ---------------------------------------------------------------------------
# GCNN-14B (``gcnn_lines``) over phase 13's words, trained by ``cli.train_lm``
# in fp32 on ~1 M tokens of phase 13's Markov chain, then the ConvLM of three
# decodes (``--lmtype=convlm``). The width is never cut; the utterances and
# the beam are.
LM_TOKENS, LM_BATCH, LM_BPTT, LM_UPDATES = 1_000_000, 16, 64, 30
LM_TRAIN = dict(lr=0.5, momentum=0.9, maxgradnorm=0.1, reportiters=10, seed=0)
LM_ROW_TOL = 1e-4  # ConvLM log10 rows, card against CPU, fp32: 40 layers of 2048-term sums
LM_REQUESTS = 32  # deferred requests of the rows' check (one bucket of 32 on each side)
LM_TEST_UTTS = 2
LM_PY_UTTS = 1  # the native beam's words against the Python beam's
LM_DECODE = dict(lmtype="convlm", lm_memory=20000, lmweight=1.0, wordscore=1.0,
                 beamsize=32, beamthreshold=25, smearing="max", uselexicon=True,
                 decodertype="wrd", nthread_decoder=2, batchsize=4)
# the AMs the LM decodes with: phase 13's flagship (CTC), phase 14's conv_glu
# (ASG) and phase 16's seq2seq_tds, each with its phase's decode flags
LM_AMS = {
    "flagship": dict(spec=FLAGSHIP, flags={}),
    "conv_glu": dict(spec=None, flags=dict(silscore=-0.5)),
    "seq2seq_tds": dict(spec=S2S_RECIPES["seq2seq_tds"],
                        flags=dict(eosscore=-1.0, hardselection=1.5, softselection=10.0,
                                   attentionthreshold=math.inf, nthread_decoder=1)),
}
# the new layers at widths a model would use: forward and backward card
# against CPU, in training mode (BN on the batch's statistics, which it also
# moves) and in eval mode; (C in, arch lines from (B, 1, C, T))
LAYER_ROWS = {
    "bn_1024": (1024, ["V -1 1 1024 0", "BN 1024 2", "RO 2 0 3 1", "L 1024 32"]),
    "lstm_512_bi_2": (256, ["V -1 1 256 0", "RO 2 0 3 1", "LSTM 256 512 2 1", "L 1024 32"]),
    "gru_512_bi_2": (256, ["V -1 1 256 0", "RO 2 0 3 1", "GRU 256 512 2 1", "L 1024 32"]),
    "rnn_512_2": (256, ["V -1 1 256 0", "RO 2 0 3 1", "RNN 256 512 2 0", "L 512 32"]),
    "posemb_sin_pc": (512, ["V -1 1 512 0", "RO 2 0 3 1", "POSEMB 512 256 0.0",
                            "SINPOSEMB 512", "PC f64", "PC f32", "L 512 32"]),
}
LAYER_TOL = 1e-4  # fp32 (TF32 off), sums of <= 1024 terms and 60 steps in another order
# an acoustic arch of the new layers for cli.train and continue: BN over the
# 80 bands, time pooled by 4, learnt positions, a cast, a 2-way GRU of 256
LAYERS_ARCH = """V -1 1 NFEAT 0
BN NFEAT 2
M 4 1 4 1
RO 2 0 3 1
POSEMB NFEAT 1024 0.1
PC f32
GRU NFEAT 256 1 1
L 512 NLABEL
"""


def lm_files(root, corpus):
    """The LM's files: its tokens (phase 13's words, whose lexicon the AMs
    decode with), a corpus of ``LM_TOKENS`` tokens sampled from phase 13's
    chain (``sample_chain_sentences``, seed 1) and the GCNN-14B arch over the
    words plus ``</s>`` and ``<unk>``."""
    import numpy as np

    from wav2letter_tpu_torch.tools.synth_corpus import load_chain, sample_chain_sentences

    vocab, _, chain = load_chain(0, SOAK_CORPUS["n_words"], SOAK_CORPUS["n_homophone_pairs"])
    with open(corpus["lexicon"]) as f:
        lex_words = {line.split()[0] for line in f if line.strip()}
    if set(vocab) != lex_words:
        fail(f"lm: the chain's {len(vocab)} words are not the lexicon's {len(lex_words)}")
    rng = np.random.RandomState(1)
    sents = sample_chain_sentences(chain, LM_TOKENS // 6, rng)
    paths = dict(tokens=os.path.join(root, "lm_tokens.txt"),
                 train=os.path.join(root, "lm_corpus.txt"), arch=os.path.join(root, "gcnn14b.arch"))
    with open(paths["tokens"], "w") as f:
        f.write("\n".join(vocab) + "\n")
    with open(paths["train"], "w") as f:
        f.writelines(" ".join(vocab[i] for i in s) + "\n" for s in sents)
    with open(paths["arch"], "w") as f:
        f.write("\n".join(gcnn_lines(len(vocab) + 2)) + "\n")
    return paths, sum(len(s) for s in sents), len(vocab) + 2


def lm_first_batch(paths, smi_line):
    """The first (16, 64) block's loss and every leaf's gradient, the LM in
    eval mode (dropout off), on the card against the CPU (``CARD_CPU_TOL``)."""
    import copy

    import torch

    from wav2letter_tpu_torch.cli.train_lm import lm_corpus
    from wav2letter_tpu_torch.data.dictionary import Dictionary
    from wav2letter_tpu_torch.models.lm import build_lm_model, lm_cross_entropy

    vocab = Dictionary.from_file(paths["tokens"])
    eos, unk = vocab.add_entry("</s>"), vocab.add_entry("<unk>")
    ids = torch.from_numpy(lm_corpus(paths["train"], vocab, eos, unk, LM_BATCH, LM_BPTT)
                           [:, :LM_BPTT])
    torch.manual_seed(0)
    cpu = build_lm_model(paths["arch"], len(vocab)).eval()
    card = copy.deepcopy(cpu).cuda()
    res = {}
    for side, m in (("cpu", cpu), ("card", card)):
        x = ids.to(next(m.parameters()).device)
        t0 = time.perf_counter()
        logits, _ = m(x)
        loss = lm_cross_entropy(logits, x).mean() / LM_BPTT
        loss.backward()
        res[side] = (loss.item(), {n: p.grad.float().cpu() for n, p in m.named_parameters()},
                     time.perf_counter() - t0)
    errs = _leaf_errors(res["card"][1], res["cpu"][1], {})
    worst = max(errs, key=errs.get)
    loss_rel = abs(res["card"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    out = dict(loss_card=res["card"][0], loss_cpu=res["cpu"][0], loss_rel_err=loss_rel,
               worst_leaf=worst, worst_leaf_err=errs[worst], leaves=len(errs),
               cpu_s=res["cpu"][2], tol=list(CARD_CPU_TOL), nvidia_smi=smi_line)
    if loss_rel > CARD_CPU_TOL[0] or errs[worst] > CARD_CPU_TOL[1]:
        fail(f"lm first batch, card against CPU: {json.dumps(out)}")
    log(f"[lm first batch] {json.dumps(out)}")
    del cpu, card
    torch.cuda.empty_cache()
    return out


def lm_train(root, paths, smi_line):
    """``cli.train_lm`` (its ``train_lm`` and ``save_lm``) on the card:
    ``LM_UPDATES`` updates at B = 16, bptt 64, fp32; the loss must fall and no
    kernel of ours launch."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.cli.train_lm import save_lm, train_lm
    from wav2letter_tpu_torch.config import Config

    cfg = Config.from_sources(argv=[f"--{k}={v}" for k, v in dict(
        LM_TRAIN, arch=paths["arch"], train=paths["train"], tokens=paths["tokens"],
        batchsize=LM_BATCH, iter=LM_UPDATES, rundir=os.path.join(root, "lm_run")).items()])
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_lm(cfg, LM_BPTT, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = card_launches("lm training", {})
    save_lm(cfg, out)
    losses = out["losses"]
    n_params = sum(p.numel() for p in out["model"].parameters())
    res = dict(updates=out["updates"], losses=losses, first5=sum(losses[:5]) / 5,
               last5=sum(losses[-5:]) / 5, wall_s=wall, s_per_update=wall / out["updates"],
               tokens_per_s=LM_BATCH * LM_BPTT * out["updates"] / wall, n_params=n_params,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches,
               nvidia_smi=smi_line)
    if out["updates"] != LM_UPDATES or not all(math.isfinite(v) for v in losses) \
            or not res["last5"] < res["first5"]:
        fail(f"lm training: {json.dumps(res)}")
    log(f"[lm train] {json.dumps(res)}")
    del out
    torch.cuda.empty_cache()
    return res, cfg.rundir


def convlm_rows(lm_dir, corpus, smi_line):
    """``ConvLM.score_batch`` on the card against the CPU on the same weights
    and requests (histories of the test transcripts' words, 1-48 long): the
    largest log10 difference within ``LM_ROW_TOL``; and one bucket's device
    time on the card."""
    import numpy as np

    from wav2letter_tpu_torch.decoder.convlm import load_convlm

    with open(corpus["lexicon"]) as f:
        words = list(dict.fromkeys(line.split()[0] for line in f if line.strip()))
    lms = {dev: load_convlm(os.path.join(lm_dir, "lm_model.bin"),
                            os.path.join(lm_dir, "lm_vocab.txt"), usr_vocab=words,
                            device=dev) for dev in ("cuda", "cpu")}
    with open(corpus["test"]) as f:
        text = [w for line in f for w in line.split()[3:]]
    ids = [lms["cpu"].usr_map[words.index(w)] for w in text]
    rng = np.random.RandomState(5)
    lens = rng.randint(1, 49, LM_REQUESTS)
    starts = rng.randint(0, len(ids) - 49, LM_REQUESTS)
    hists = np.zeros((LM_REQUESTS, 48), np.int32)
    for i, (s, n) in enumerate(zip(starts, lens)):
        hists[i, :n] = ids[s: s + n]
    target = np.asarray([ids[s + n] for s, n in zip(starts, lens)], np.int32)
    got = lms["cuda"].score_batch(hists, lens, target)
    want = lms["cpu"].score_batch(hists, lens, target)
    err = float(np.abs(got - want).max())
    st = lms["cuda"].stats
    out = dict(requests=LM_REQUESTS, max_abs_err_log10=err, tol=LM_ROW_TOL,
               bucket_device_ms=st["device_ms"] / st["device_calls"],
               mean_log10=float(want.mean()), nvidia_smi=smi_line)
    if not err <= LM_ROW_TOL:
        fail(f"ConvLM rows, card against CPU: {json.dumps(out)}")
    log(f"[lm rows] {json.dumps(out)}")
    return out


def lm_beams(name, am, lst, lm_dir, flags):
    """On the ``LM_PY_UTTS`` shortest utterances, the native beam's words
    against the Python beam's, both with the ConvLM on the card."""
    import torch

    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data import AsrDataset
    from wav2letter_tpu_torch.runtime.decode import (S2SBeamParts, build_decoder,
                                                     result_to_words, s2s_words)
    from wav2letter_tpu_torch.runtime.test import Evaluator

    lst, _ = shortest(lst, lst[:-4] + "_py.lst", LM_PY_UTTS)
    ev = Evaluator(Config().update(dict(am=am, test=lst)), device="cuda")
    cfg = ev.cfg
    cfg.update(dict(flags, lm=os.path.join(lm_dir, "lm_model.bin"),
                    lm_vocab=os.path.join(lm_dir, "lm_vocab.txt")))
    ds = AsrDataset(lst, ev.token_dict, ev.lexicon, cfg, batch_size=LM_PY_UTTS)
    em, elen = ev.emissions(ds.materialize(ds.batch_specs()[0]))
    ems = [em[i, : int(elen[i])].float().cpu().numpy() for i in range(LM_PY_UTTS)]
    words, secs = {}, {}
    for native in (True, False):
        t0 = time.perf_counter()
        if ev.is_s2s:
            parts = S2SBeamParts(cfg, ev.token_dict, ev.lexicon, use_native=native,
                                 device=ev.device)
            eos, L = ev.n_classes - 2, cfg.maxdecoderoutputlen
            res = [parts.decoder(ev.s2s_criterion, e, eos, L).decode(n_best=1)[0] for e in ems]
            words[native] = [s2s_words(r, parts.word_dict, ev.token_dict, cfg, ev.n_classes)
                             for r in res]
        else:
            trans = None if ev.transitions is None else ev.transitions.cpu().numpy()
            dec, wd = build_decoder(cfg, ev.token_dict, ev.lexicon, trans, use_native=native,
                                    device=ev.device)
            res = [dec.decode(e, 1)[0] for e in ems]
            words[native] = [result_to_words(r, wd, ev.token_dict, cfg, ev.n_classes)
                             for r in res]
        secs[native] = time.perf_counter() - t0
    if words[True] != words[False]:
        fail(f"{name} with the ConvLM: native beam {words[True]} against Python {words[False]}")
    del ev, em
    torch.cuda.empty_cache()
    return dict(utterances=LM_PY_UTTS, words=words[True], native_s=secs[True],
                python_s=secs[False])


def lm_decode(name, am, lst, secs, tmp, lm_dir, smi_line):
    """``cli.decode --lmtype=convlm`` (``W2L_REQUIRE_NATIVE=1``) of ``am`` on
    ``lst``: the AM's launches as its phase counts them, audio s per wall s,
    the ConvLM's device calls, cache hit rate and device ms."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.cli.decode import main as decode_main

    spec, extra = LM_AMS[name]["spec"], LM_AMS[name]["flags"]
    n_batches = -(-LM_TEST_UTTS // LM_DECODE["batchsize"])
    flags = dict(LM_DECODE, **extra, am=am, test=lst, sclite=os.path.join(tmp, f"lm_{name}"),
                 lm=os.path.join(lm_dir, "lm_model.bin"),
                 lm_vocab=os.path.join(lm_dir, "lm_vocab.txt"))
    os.environ["W2L_REQUIRE_NATIVE"] = "1"
    kernels.reset_launches()
    res = decode_main([f"--{k}={v}" for k, v in flags.items()])
    torch.cuda.synchronize()
    launches = card_launches(f"{name} decode with the ConvLM",
                             None if spec is None else expected_launches(spec, 0, n_batches))
    lm = res.get("convlm", {})
    if not (math.isfinite(res["WER"]) and res["decoder"].startswith("Native")
            and lm.get("device_calls", 0) > 0):
        fail(f"{name} decode with the ConvLM: {json.dumps(res)}")
    # the rate after set-up: the AM's (setup_s), and the ConvLM's, which each
    # consumer thread loads for itself (load_s, summed over the threads)
    n_threads = flags["nthread_decoder"]
    out = dict(res, audio_s_per_s=secs / (res["wall_s"] - res["setup_s"]),
               audio_s_per_s_after_lm_load=secs / (res["wall_s"] - res["setup_s"]
                                                    - lm["load_s"] / n_threads),
               cache_hit_rate=lm["hits"] / max(1, lm["lookups"]), launches=launches,
               nvidia_smi=smi_line)
    log(f"[lm decode {name}] {json.dumps(out)}")
    return out


def new_layers_card_vs_cpu(smi_line):
    """``LAYER_ROWS`` forward and backward, card against CPU (and BN's moved
    statistics), in training and eval mode."""
    import numpy as np
    import torch

    from wav2letter_tpu_torch.models import build_arch_from_lines

    out = {}
    for name, (c, lines) in LAYER_ROWS.items():
        for train in (True, False):
            torch.manual_seed(0)
            cpu = build_arch_from_lines(lines, 32)
            card = build_arch_from_lines(lines, 32)
            card.load_state_dict(cpu.state_dict())
            card.cuda()
            g = np.random.RandomState(1)
            feats = torch.from_numpy(g.randn(4, 60, c).astype(np.float32))
            flen = torch.tensor([60, 54, 48, 42])
            res = []
            for m, dev in ((cpu, "cpu"), (card, "cuda")):
                m.train(train)
                t0 = time.perf_counter()
                y, _ = m(feats.to(dev), flen.to(dev))
                (y * torch.linspace(-1, 1, y.numel(), device=dev).view(y.shape)).sum().backward()
                if dev == "cuda":
                    torch.cuda.synchronize()
                res.append((y.detach().cpu(), {k: p.grad.cpu() for k, p in m.named_parameters()},
                            {k: b.cpu() for k, b in m.named_buffers()},
                            time.perf_counter() - t0))
            (y0, g0, b0, t_cpu), (y1, g1, b1, t_card) = res
            err = ((y1 - y0).abs().max() / y0.abs().max().clamp(min=1.0)).item()
            gerr = max(((g1[k] - g0[k]).abs().max() / g0[k].abs().max().clamp(min=1e-30)).item()
                       for k in g0)
            berr = max([(b1[k] - b0[k]).abs().max().item() for k in b0] or [0.0])
            key = f"{name}_{'train' if train else 'eval'}"
            out[key] = dict(out_err=err, grad_err_share=gerr, stats_err=berr,
                            card_s=t_card, cpu_s=t_cpu)
            if not (err <= LAYER_TOL and gerr <= LAYER_TOL and berr <= LAYER_TOL):
                fail(f"layer {key}, card against CPU: {json.dumps(out[key])}")
    log(f"[lm layers] {json.dumps(out)} | {smi_line}")
    return out


def layers_train_continue(root, corpus, smi_line):
    """``cli.train`` 2 updates then ``continue`` 2 (the ``Trainer`` that
    ``cli.train continue`` runs) on ``LAYERS_ARCH`` (BN, GRU, POSEMB, PC):
    the BN buffers reloaded in equal bits, moved by training, every loss
    finite, K1 alone launched."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.cli.train import main as train_main
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.runtime.checkpoint import load_checkpoint
    from wav2letter_tpu_torch.runtime.train import Trainer

    arch = os.path.join(root, "layers.arch")
    with open(arch, "w") as f:
        f.write(LAYERS_ARCH)
    train_lst, _ = shortest(corpus["train"], os.path.join(root, "layers_train.lst"), 16)
    flags = dict(arch=arch, train=train_lst, tokens=corpus["tokens"], lexicon=corpus["lexicon"],
                 rundir=os.path.join(root, "layers_runs"), runname="layers", criterion="ctc",
                 mfsc=True, filterbanks=N_FEAT, batchsize=8, lr=0.1, netoptim="sgd",
                 momentum=0.9, maxgradnorm=1.0, compute_dtype="float32", nthread=2, seed=0,
                 iter=2, reportiters=2)
    kernels.reset_launches()
    with _train_steps() as rec:
        train_main(["train"] + [f"--{k}={v}" for k, v in flags.items()])
        last = os.path.join(flags["rundir"], "layers", "model_last.bin")
        saved = load_checkpoint(last).state_dict
        tr = Trainer(Config().update(dict(rundir=flags["rundir"], runname="layers", iter=4,
                                          reportiters=2)), mode="continue", device="cuda")
        bufs = {k: b.cpu() for k, b in tr.model.named_buffers()}
        reloaded = all(torch.equal(bufs[k], saved[k]) for k in bufs) and len(bufs) == 2
        tr.run()
    end = load_checkpoint(last)
    launches = card_launches("layers arch training")
    losses = [s["loss"] for s in rec.calls]
    moved = (end.state_dict["seq.01_BN.var"] - saved["seq.01_BN.var"]).abs().max().item()
    out = dict(updates=end.updates, losses=losses, buffers_reloaded_equal=reloaded,
               bn_var_moved_in_continue=moved, launches=launches, nvidia_smi=smi_line)
    if not (reloaded and end.updates == 4 and len(losses) == 4 and moved > 0
            and all(math.isfinite(v) for v in losses)):
        fail(f"layers arch train and continue: {json.dumps(out)}")
    log(f"[lm layers train] {json.dumps(out)}")
    del tr
    torch.cuda.empty_cache()
    return out


def lm_path(tmp, corpus, ams, smi_line):
    """Phase 18: GCNN-14B (``gcnn_lines``, 128/512-4096 wide, over phase
    13's words) trained with ``cli.train_lm`` (``LM_UPDATES`` updates in fp32,
    the first batch card against CPU, no kernel of ours launched); the
    ConvLM's rows card against CPU; ``cli.decode --lmtype=convlm`` of
    ``LM_TEST_UTTS`` test utterances through ``ams`` (phase 13's flagship with
    CTC, phase 14's conv_glu with ASG, phase 16's seq2seq_tds; their kernels'
    launches counted as their phases count them) and the native beam's words
    against the Python beam's on the two shortest; the new layers card
    against CPU at model widths; ``LAYERS_ARCH`` trained and continued."""
    import torch

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "lm")
    os.makedirs(root, exist_ok=True)
    laps = {}
    paths, n_tokens, V = lm_files(root, corpus)
    laps["files"] = time.perf_counter() - t_phase
    first = lm_first_batch(paths, smi_line)
    laps["first_batch"] = time.perf_counter() - t_phase
    trained, lm_dir = lm_train(root, paths, smi_line)
    laps["train"] = time.perf_counter() - t_phase
    rows = convlm_rows(lm_dir, corpus, smi_line)
    laps["rows"] = time.perf_counter() - t_phase
    test_lst, test_secs = shortest(corpus["test"], os.path.join(root, "test.lst"), LM_TEST_UTTS)
    decodes, beams = {}, {}
    for name, am in ams.items():
        decodes[name] = lm_decode(name, am, test_lst, test_secs, root, lm_dir, smi_line)
        beams[name] = lm_beams(name, am, test_lst, lm_dir,
                               dict(LM_DECODE, **LM_AMS[name]["flags"]))
        log(f"[lm beams {name}] {json.dumps(beams[name])} | {smi_line}")
        laps[f"decode_{name}"] = time.perf_counter() - t_phase
    layers = new_layers_card_vs_cpu(smi_line)
    laps["layers"] = time.perf_counter() - t_phase
    layers_run = layers_train_continue(root, corpus, smi_line)
    laps["layers_train"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    out = dict(vocab=V, lm_tokens=n_tokens, n_params=trained["n_params"], first_batch=first,
               training=trained, rows=rows, decodes=decodes, beams=beams, layers=layers,
               layers_train=layers_run, phase_s=time.perf_counter() - t_phase, laps_s=laps,
               nvidia_smi=smi_line)
    log(f"[lm] phase 18 in {out['phase_s']:.1f} s (laps {json.dumps(laps)}) | {smi_line}")
    return out


# ---------------------------------------------------------------------------
# phase 19: the hooks of cli.train and cli.test
# ---------------------------------------------------------------------------
MLS_PLUGIN = os.path.join(REPO, "recipes", "mls", "mling_plugin.py")
MLS_CFG = os.path.join(REPO, "recipes", "mls", "train_english.cfg")
MLS_TRAIN_UTTS, MLS_TEST_UTTS = 16, 8  # the shortest: T <= 240 after the pool
# phase 13's corpus generator (its seed: the same words, tokens and lexicon)
# at 2-3 words a sentence: ~1.6-4.5 s, where phase 13's 4-8 words make 4-8 s,
# past K4's gate after the plugin's one pool at --pad_multiple=128
MLS_CORPUS = dict(SOAK_CORPUS, train_hours=0.025, dev_minutes=0.1, test_minutes=0.5,
                  lm_sentences=10, min_words=2, max_words=3)
MLS_UPDATES = {"float32": 3, "bfloat16": 2}
MLS_BPTT = 240  # the plugin's TR layers: K4's gate is T <= bptt after the pool
# the plugin's encoder: 4 TR layers of H = 4, Dh = 64 over 256 after one
# stride-2 pool of a weight-normed conv (F.conv2d); layerdrop scales, not skips
MLS_SPEC = dict(name="mls", per_forward={"mfsc": 1, "mhsa": 4, "residual_ln": 8},
                per_backward={"mhsa_bwd": 4, "residual_ln_bwd": 8})
HOOK_UTTS, HOOK_UPDATES = 32, 2  # the flagship's hooks: 2 updates at B = 16 each
NOISE_CLIPS = 4  # synthesized noise files of the sfx chain's AdditiveNoise
HOOK_RANKS = 2


def _sfx_config(root):
    """A chain of all six effects, its noise list synthesized (coloured noise
    of 1-3 s)."""
    import numpy as np

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(5)
    clips = []
    for i in range(NOISE_CLIPS):
        n = int(16000 * rng.uniform(1.0, 3.0))
        clips.append(os.path.join(root, f"noise{i}.npy"))
        np.save(clips[-1], np.cumsum(0.05 * rng.randn(n)).astype(np.float32) % 0.3)
    with open(os.path.join(root, "noise.txt"), "w") as f:
        f.write("\n".join(clips) + "\n")
    chain = [
        {"type": "Amplify", "conf": {"ratioMin": 0.7, "ratioMax": 1.3}},
        {"type": "AdditiveNoise", "conf": {"listFilePath": os.path.join(root, "noise.txt"),
                                           "minSnr": 10, "maxSnr": 30, "nClipsMax": 2}},
        {"type": "ReverbEcho", "conf": {"proba": 0.8, "repeatMax": 4}},
        {"type": "TimeStretch", "conf": {"factorMin": 0.9, "factorMax": 1.1, "proba": 0.8}},
        {"type": "Normalize", "conf": {"onlyIfTooHigh": True}},
        {"type": "ClampAmplitude", "conf": {}},
    ]
    path = os.path.join(root, "sfx.json")
    with open(path, "w") as f:
        json.dump(chain, f)
    return path


def _k4_rows_spy():
    """Wraps ``KERNELS.mhsa``: the rows (utterances x model blocks) of each
    launch; ``restore`` undoes it."""
    from wav2letter_tpu_torch import kernels

    rows, orig = [], kernels.KERNELS.mhsa

    def mhsa(q, *a):
        rows.append(int(q.shape[0]))
        return orig(q, *a)

    kernels.KERNELS.mhsa = mhsa
    return rows, lambda: setattr(kernels.KERNELS, "mhsa", orig)


def mls_path(root, corpus, smi_line):
    """The mls plugin at full width through the port's binaries:
    ``recipes/mls/train_english.cfg`` with ``--arch=recipes/mls/mling_plugin.py``
    (the loader maps the flax file to ``plugins/mling.py``) on phase 13's
    corpus made with 2-3 words a sentence (``MLS_CORPUS``; letters and its
    separator, not the recipe's word pieces; the ``MLS_TRAIN_UTTS`` shortest,
    whose padded T stays inside K4's gate after the pool): the first batch
    card against CPU (``CARD_CPU_TOL``), K4, K4b,
    K3 and K3b at the update's shapes against their plain versions, 3 fp32 and
    2 bf16 updates through ``cli.train`` with every update's launches held
    to the arch (the rows through K4 counted), ``continue`` for 1, then
    ``cli.test``."""
    import torch

    from wav2letter_tpu_torch.cli.test import main as test_main
    from wav2letter_tpu_torch.cli.train import main as train_main
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data import AsrDataset, make_token_dict
    from wav2letter_tpu_torch.models.plugin import load_plugin_module
    from wav2letter_tpu_torch.plugins.mling import MultilingualAM
    from wav2letter_tpu_torch.runtime.checkpoint import load_checkpoint

    from wav2letter_tpu_torch.tools.synth_corpus import generate

    t_phase = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    short = generate(os.path.join(root, "corpus"), **MLS_CORPUS)
    for k in ("tokens", "lexicon"):
        if open(short[k]).read() != open(corpus[k]).read():
            fail(f"mls: the short corpus's {k} differ from phase 13's")
    train_lst, _ = shortest(short["train"], os.path.join(root, "train.lst"), MLS_TRAIN_UTTS)
    test_lst, test_secs = shortest(short["test"], os.path.join(root, "test.lst"),
                                   MLS_TEST_UTTS)
    flags = dict(flagsfile=MLS_CFG, arch=MLS_PLUGIN, train=train_lst, tokens=corpus["tokens"],
                 lexicon=corpus["lexicon"], rundir=os.path.join(root, "runs"), nthread=2,
                 seed=0, **S2S_LETTERS)
    cfg = Config.from_sources(argv=[f"--{k}={v}" for k, v in flags.items()])
    td = make_token_dict(cfg.tokens, cfg.criterion)
    with torch.device("meta"):
        model = load_plugin_module(MLS_PLUGIN, cfg.num_features(), len(td))
    if not isinstance(model, MultilingualAM):
        fail(f"mls: the plugin loaded as {type(model).__name__}")
    n_params = sum(p.numel() for p in model.parameters())
    specs = AsrDataset(cfg.train, td, None, cfg).batch_specs()
    big = max(specs, key=lambda sp: sp.max_input_frames * len(sp.indices))
    B, T = len(big.indices), big.max_input_frames
    Ta = -(-T // 2)  # the plugin's stride-2 pool
    if max(sp.max_input_frames for sp in specs) > 2 * MLS_BPTT:
        fail(f"mls: a batch of {max(sp.max_input_frames for sp in specs)} frames is past "
             f"K4's gate (T <= {MLS_BPTT} after the pool)")
    log(f"[mls] phase 19: {n_params} parameters ({cfg.num_features()} banks, {len(td)} "
        f"classes), {len(specs)} batches, the largest B={B} T={T} ({Ta} after the pool) | "
        f"{smi_line}")
    laps = {}
    per_update = expected_launches(MLS_SPEC, 1, 0)
    first = card_vs_cpu_first_batch("mls", flags, per_update, dtypes=("float32",))
    laps["first_batch"] = time.perf_counter() - t_phase
    kernel_rows, details = {}, []
    lns = [(B * Ta, 256)] * 8
    for dt in ("float32", "bfloat16"):
        att = check_attention([("mls", B, Ta, 4, 64, True, 4)], dt, details)
        kernel_rows[("mhsa", dt)] = att["mhsa"]
        kernel_rows[("mhsa_bwd", dt)] = att["mhsa_bwd"]
        kernel_rows[("residual_ln", dt)] = check_residual_ln(lns, dt, details)
        kernel_rows[("residual_ln_bwd", dt)] = check_residual_ln_bwd(lns, dt, details)
        torch.cuda.empty_cache()
    bad = [r for r in details if not r["ok"]]
    if bad:
        fail(f"mls: {len(bad)} kernel checks disagree with the plain versions: "
             f"{json.dumps(bad[0])}")
    laps["kernels"] = time.perf_counter() - t_phase
    k4_rows, restore = _k4_rows_spy()
    try:
        runs = trained_runs("mls", flags, MLS_UPDATES, smi_line, expect=per_update)
    finally:
        restore()
    n_upd = sum(MLS_UPDATES.values())
    rows_k4 = dict(launches=len(k4_rows), rows=sum(k4_rows))
    # every forward of every update (4 layers) through K4, each over the batch's rows
    if len(k4_rows) != 4 * (n_upd + 2) or not all(r > 0 for r in k4_rows):
        fail(f"mls: K4 took {len(k4_rows)} launches ({k4_rows}) in {n_upd} updates")
    laps["train"] = time.perf_counter() - t_phase
    run, n0 = "mls_float32", MLS_UPDATES["float32"]
    from wav2letter_tpu_torch import kernels

    kernels.reset_launches()
    with _train_steps() as rec:
        train_main(["continue", f"--rundir={flags['rundir']}", f"--runname={run}",
                    f"--iter={n0 + 1}", f"--reportiters={n0 + 1}"])
    card_launches("mls continue", per_update)
    last = os.path.join(flags["rundir"], run, "model_last.bin")
    ckpt = load_checkpoint(last)
    if ckpt.updates != n0 + 1 or len(rec.calls) != 1 or not rec.calls[0]["finite"] \
            or Config.deserialize(ckpt.config).arch != MLS_PLUGIN:
        fail(f"mls continue: update {ckpt.updates}, "
             f"steps {[(c['loss'], c['finite']) for c in rec.calls]}")
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = test_main([f"--am={last}", f"--test={test_lst}", "--batchsize=4"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not math.isfinite(res["loss"]):
        fail(f"mls cli.test: {res}")
    # the recipe's dynamic batching, stored in the checkpoint, sets the batches
    n_batches = max(1, kernels.LAUNCHES["mfsc"])
    test = dict(res, wall_s=wall, audio_s_per_s=test_secs / wall, batches=n_batches,
                launches=card_launches("mls cli.test", expected_launches(MLS_SPEC, 0,
                                                                         n_batches)))
    laps["test"] = time.perf_counter() - t_phase
    out = dict(n_params=n_params, batch=[B, T, Ta], first_batch=first, runs=runs,
               k4_rows=rows_k4, continued=dict(loss=rec.calls[0]["loss"]), test=test,
               kernel_rows={f"{k[0]}@{k[1]}": v for k, v in kernel_rows.items()},
               laps_s=laps, nvidia_smi=smi_line)
    log(f"[mls] {json.dumps(dict(rows_k4=rows_k4, update=runs['float32'].get('update'), test=test, laps=laps))}")
    return out


def _hook_runs(root, data, smi_line):
    """The flagship at full width (B = 16, bf16, ``HOOK_UPDATES`` updates
    each, on synthesized utterances of 4-8 s): as it is, with ``--remat``,
    with ``--features_device=host`` and with ``--sfx_config`` (all six
    effects). Each run's launches are held to its hook: remat launches every
    forward kernel twice an update but K1 (the featurizer runs outside the
    recomputed forward), host features no K1; remat's and host features'
    first loss to the plain run's. The data threads' ms a batch (plain, host
    features, sfx) and the peak memory with and without remat."""
    import torch

    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.runtime.train import Trainer

    lst, tokens, lexicon = data
    base = train_flags(FLAGSHIP, lst, lst, tokens, lexicon, "", "bfloat16", HOOK_UPDATES)
    base.update(valid="", runname="", reportiters=HOOK_UPDATES)  # no run dir, no checkpoint
    plain = expected_launches(FLAGSHIP, HOOK_UPDATES, 0)
    fwd = FLAGSHIP["per_forward"]
    hooks = {
        "plain": ({}, plain),
        "remat": (dict(remat=True), {k: v + (fwd.get(k, 0) * HOOK_UPDATES
                                             if k != "mfsc" else 0)
                                     for k, v in plain.items()}),
        "host_features": (dict(features_device="host"), dict(plain, mfsc=0)),
        "sfx": (dict(sfx_config=_sfx_config(root)), plain),
    }
    out = {}
    for name, (extra, want) in hooks.items():
        cfg = Config()
        cfg.update(dict(base, **extra))
        tr = Trainer(cfg, device="cuda")
        specs = tr.train_ds.batch_specs()
        tr.train_ds.materialize(specs[-1])  # warm: the CPU featurizer's first call
        t0 = time.perf_counter()
        for sp in specs[:2]:
            batch = tr.train_ds.materialize(sp)
        data_ms = (time.perf_counter() - t0) * 1e3 / len(specs[:2])
        if ("feats" in batch) != (name == "host_features"):
            fail(f"hooks {name}: the data threads shipped {sorted(batch)}")
        res = _drive(tr)
        if res["launches"] != want or not res["finite"] or res["updates"] != HOOK_UPDATES:
            fail(f"hooks {name}: launches {res['launches']} (expected {want}), finite "
                 f"{res['finite']}, {res['updates']} updates")
        out[name] = dict(losses=res["losses"], launches=res["launches"],
                         update_ms=res["update_ms"], peak_mem_gib=res["peak_mem_gib"],
                         data_ms_a_batch=data_ms, batch_fields=sorted(batch),
                         nvidia_smi=smi_line)
        log(f"[hooks {name}] {json.dumps(out[name])}")
        del tr
        gc.collect()  # _drive's wrapper leaves the trainer in a reference cycle
        torch.cuda.empty_cache()
    p0 = out["plain"]["losses"][0]
    for name in ("remat", "host_features"):
        err = abs(out[name]["losses"][0] - p0) / abs(p0)
        out[name]["first_loss_rel_err"] = err
        # remat: the same forward on the same batch; host features: K1's
        # plain version on the CPU, then the same bf16 cast
        if err > (1e-6 if name == "remat" else DP_TOL["bfloat16"][0]):
            fail(f"hooks {name}: first loss {out[name]['losses'][0]} against {p0}")
    out["remat"]["peak_mem_saved_gib"] = out["plain"]["peak_mem_gib"] - \
        out["remat"]["peak_mem_gib"]
    log(f"[hooks] peak memory {out['plain']['peak_mem_gib']:.3f} GiB, with --remat "
        f"{out['remat']['peak_mem_gib']:.3f} GiB; data threads' ms a batch: plain "
        f"{out['plain']['data_ms_a_batch']:.1f}, host features "
        f"{out['host_features']['data_ms_a_batch']:.1f}, sfx "
        f"{out['sfx']['data_ms_a_batch']:.1f} | {smi_line}")
    return out


def hook_parallel_jobs(root, data):
    """Phase 19's jobs for two gloo ranks on the card (phase 12's harness; the
    full run adds them to phase 12's ranks), one update each, to hold against
    one process: ``LAYERS_ARCH`` (its BatchNorm's statistics over the global
    batch) at dp2, the flagship with novograd at dp1 x mp2 (its TDS linears
    split), and ``recipes/conv_glu`` at full width with CTC over the 9998
    classes at dp1 x mp2 (three weight-normed convs split over their time
    taps and the head over its outputs, as JAX splits them). Dropout 0
    everywhere. Returns (cases, jobs)."""
    lst, tokens, lexicon = data
    os.makedirs(root, exist_ok=True)
    layers = os.path.join(root, "layers.arch")
    with open(layers, "w") as f:
        f.write(LAYERS_ARCH.replace("POSEMB NFEAT 1024 0.1", "POSEMB NFEAT 1024 0.0"))
    fl_arch = _cut_arch(ARCH, os.path.join(root, "flagship_do0.arch"))
    glu_arch = _cut_arch(GLU_ARCH, os.path.join(root, "conv_glu_do0.arch"))
    n = HOOK_RANKS * 4

    def flags(arch, **kw):
        f = dict(train=lst, tokens=tokens, lexicon=lexicon, rundir="", runname="", arch=arch,
                 criterion="ctc", mfsc=True, filterbanks=N_FEAT, compute_dtype="float32",
                 nthread=2, onorm="target", sqnorm=True, iter=1, reportiters=1, seed=0,
                 netoptim="sgd", lr=0.05, momentum=0.9, maxgradnorm=0.5, batchsize=n)
        f.update(kw)
        return f

    cases = {
        "bn_dp2": (layers, flags(layers, batchsize=4), {"mfsc": 1}, []),
        "novograd_mp2": (fl_arch, flags(fl_arch, netoptim="novograd", lr=0.01, mp_axis=2,
                                        localnrmlleftctx=300),
                         expected_launches(FLAGSHIP, 1, 0), None),
        "conv_glu_mp2": (glu_arch, flags(glu_arch, mp_axis=2, filterbanks=40),
                         {"mfsc": 1}, ["seq.07_C.v", "seq.13_C.v", "seq.19_C.v",
                                       "seq.26_WNL.v"]),
    }
    jobs = [dict(name=k, flags=f, dump=os.path.join(root, f"{k}.pt"), needs="all_gather")
            for k, (_, f, _, _) in cases.items()]
    return cases, jobs


def hook_parallel_held(root, data, cases, ranks, smi_line):
    """The ranks' runs of ``hook_parallel_jobs``: launches, the replicas (DP)
    or the split (TP, JAX's decisions), and each against one process."""
    import torch

    from wav2letter_tpu_torch.models import build_arch_module
    from wav2letter_tpu_torch.parallel.sharding import split_plan

    tokens = data[1]
    n = HOOK_RANKS * 4
    out = dict(probe=ranks[0]["probe"])
    for name, (arch, f, want, split) in cases.items():
        if name not in ranks[0]["runs"]:
            fail(f"hooks {name}: not run (gloo's all-gather {ranks[0]['probe']})")
        r, other = ranks[0]["runs"][name], ranks[1]["runs"][name]
        for rr in (r, other):
            want_l = {k: want.get(k, 0) for k in rr["launches"]}
            if rr["launches"] != want_l or not rr["finite"]:
                fail(f"hooks {name}: launches {rr['launches']}, expected {want_l}; finite "
                     f"{rr['finite']}")
        n_feat, n_classes = f["filterbanks"], len(open(tokens).read().split()) + 1
        if "mp2" in name:  # JAX's split (conv_glu's as tests/test_torch_hooks.py has it)
            if split is None:
                with torch.device("meta"):
                    split = sorted(split_plan(build_arch_module(arch, n_feat, n_classes), 2))
            if not split or r["sharded"] != sorted(split):
                fail(f"hooks {name}: split {r['sharded']}, expected {split}")
            r["split"] = split
        elif r["digest"] != other["digest"]:
            fail(f"hooks {name}: the replicas differ")
        ref_flags = dict(f, mp_axis=1, batchsize=n)
        torch.manual_seed(ref_flags["seed"])  # the trainers' seeded start
        p0 = {k: v.detach().clone() for k, v in
              build_arch_module(arch, n_feat, n_classes).state_dict().items()}
        ref_tr, ref, ref_p = _one_process(ref_flags)
        got_p = torch.load(os.path.join(root, f"{name}.pt"))
        r["held"] = _held(name, "float32", r, ref, got_p, ref_p, p0)
        if name == "bn_dp2":  # the running statistics moved alike
            stats = [k for k in got_p if k.endswith((".mean", ".var"))]
            if not stats or any((got_p[k] - ref_p[k]).abs().max() > 1e-4 * (
                    1 + ref_p[k].abs().max()) for k in stats):
                fail(f"hooks bn_dp2: running statistics {stats} differ from one process")
        r["one_process"] = {k: ref[k] for k in ("losses", "update_ms", "peak_mem_gib")}
        out[name] = r
        del ref_tr
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[hooks parallel] {json.dumps({k: v for k, v in out.items() if k != 'probe'})} | "
        f"{smi_line}")
    return out


def hook_data(root, seed):
    """The hooks' utterances: 32 synthesized ones of 4-8 s over the flagship's
    9998 classes."""
    lst, tokens, lexicon, _ = synth_dataset(os.path.join(root, "data"), seed + 19, HOOK_UTTS,
                                            "hooks", dur=(4.0, 8.0))
    return lst, tokens, lexicon


def hooks_path(tmp, corpus, smi_line, seed, parallel=True):
    """Phase 19: the mls plugin (``mls_path``), the flagship's hooks
    (``_hook_runs``) and, with ``parallel`` (the full run has phase 12's
    ranks run them), BatchNorm, novograd and conv_glu on two gloo ranks."""
    t_phase = time.perf_counter()
    root = os.path.join(tmp, "hooks")
    out = dict(mls=mls_path(os.path.join(root, "mls"), corpus, smi_line))
    out["laps_s"] = {"mls": time.perf_counter() - t_phase}
    data = hook_data(root, seed)
    out["flagship"] = _hook_runs(os.path.join(root, "flagship"), data, smi_line)
    out["laps_s"]["flagship"] = time.perf_counter() - t_phase
    if parallel:
        cases, jobs = hook_parallel_jobs(os.path.join(root, "parallel"), data)
        ranks = _run_ranks(HOOK_RANKS, jobs, os.path.join(root, "parallel"))
        out["parallel"] = hook_parallel_held(os.path.join(root, "parallel"), data, cases,
                                             ranks, smi_line)
        out["laps_s"]["parallel"] = time.perf_counter() - t_phase
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[hooks] phase 19 in {out['phase_s']:.1f} s (laps {json.dumps(out['laps_s'])}) | "
        f"{smi_line}")
    return out


# ---------------------------------------------------------------------------
# phase 20: the semi- and self-supervised trainers
# ---------------------------------------------------------------------------
CPC_ARCHS = [os.path.join(REPO, "recipes", "cpc", f"{n}.arch")
             for n in ("encoder", "context", "predict")]
CPC_CFG = os.path.join(REPO, "recipes", "cpc", "pretrain.cfg")
SLIM_CFG = os.path.join(REPO, "recipes", "slimipl", "train.cfg")
LPM_CFG = os.path.join(REPO, "recipes", "local_prior_match", "train.cfg")
# phase 13's corpus, its shortest utterances; CPC's first batch card against
# CPU takes the 4 shortest, so that the CPU's full-width update stays short
CPC_UTTS, CPC_CHECK_UTTS = 16, 4
SLIM_UTTS, SLIM_UPDATES = 32, 6
LPM_UTTS, LPM_CHECK_UTTS = 16, 4
IPL_TRAIN_UTTS, IPL_UNSUP_UTTS = 16, 8
# per update of either phase, as recipes/cpc's archs imply: the encoder's
# first conv (C 1 512 10 5 3 on raw audio) is time-only and takes the audio
# (K2, no dgrad, K2b); its four 512-channel convs are past K2's shared memory
# (F.conv2d), its LNs plain; each of the six TR layers takes K3 twice, and K4
# only where T <= bptt = 128 frames, 0.64 s of audio at the encoder's stride of
# 80 samples, far below phase 13's utterances (unfused attention). No K1: raw
# features.
CPC_SPEC = dict(name="cpc", per_forward={"time_conv": 1, "residual_ln": 12},
                per_backward={"time_conv_wgrad": 1, "residual_ln_bwd": 12})
# an LPM proposal: one forward of seq2seq_tds's encoder (its greedy decode runs
# no kernel of ours)
LPM_SPEC = S2S_RECIPES["seq2seq_tds"]
# recipes/local_prior_match/train.cfg runs in neither package as it stands: it
# sets no features for seq2seq_tds's arch (80 banks: that recipe's --mfsc
# --filterbanks=80) and no --encoderdim, which its content attention needs to
# equal the arch's output of 1024
LPM_FIX = dict(mfsc=True, filterbanks=N_FEAT, encoderdim=1024)


def _argv(flags):
    return [f"--{k}={v}" for k, v in flags.items()]


def _kernel_shapes():
    """Wraps ``KERNELS.time_conv`` and ``KERNELS.residual_ln``: each call's
    key as ``check_time_conv`` (B, T, F, C, CO, K, stride, pads) and
    ``check_residual_ln`` (R, D) take it; ``restore`` undoes it."""
    from wav2letter_tpu_torch import kernels

    convs, lns = [], []
    tc, ln = kernels.KERNELS.time_conv, kernels.KERNELS.residual_ln

    def time_conv(z, w, freq, stride, pads, *a, **kw):
        K, C, CO = w.shape
        convs.append((z.shape[0], z.shape[1], freq, C, CO, K, stride, tuple(pads)))
        return tc(z, w, freq, stride, pads, *a, **kw)

    def residual_ln(x, *a, **kw):
        lns.append(tuple(x.shape))
        return ln(x, *a, **kw)

    kernels.KERNELS.time_conv, kernels.KERNELS.residual_ln = time_conv, residual_ln

    def restore():
        kernels.KERNELS.time_conv, kernels.KERNELS.residual_ln = tc, ln

    return convs, lns, restore


def _grads(net):
    return {n: (p.grad.detach().float().cpu() if p.grad is not None else None)
            for n, p in net.named_parameters()}


def cpc_semi(root, corpus, smi_line):
    """``recipes/cpc`` (``pretrain.cfg``: raw audio, B = 8, adam; its three
    archs at full width) on phase 13's shortest utterances, the list both
    ``--train`` and ``--train2``: the first batch (the 4 shortest) card
    against CPU in the unsupervised phase (the card's draws given to the CPU,
    dropout and layerdrop 0 in a copy of the context arch); 2 unsupervised and 2
    supervised updates through ``cli.train_cpc``, each update's launches held
    to ``CPC_SPEC``; ``continue`` for 1; a ``--pretrainmodel`` start from the
    saved model; one steady update's numbers; K2, K2b, K3 and K3b at the
    largest batch's shapes against their plain versions."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.cli.train_cpc import main as cpc_main
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data.batching import pad_batch_rows
    from wav2letter_tpu_torch.runtime.checkpoint import load_checkpoint
    from wav2letter_tpu_torch.runtime.train_cpc import CPCTrainer

    t_phase = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    lst, secs = shortest(corpus["train"], os.path.join(root, "train.lst"), CPC_UTTS)
    check_lst, _ = shortest(corpus["train"], os.path.join(root, "check.lst"), CPC_CHECK_UTTS)
    flags = dict(flagsfile=CPC_CFG, arch=",".join(CPC_ARCHS), train=lst, train2=lst,
                 tokens=corpus["tokens"], lexicon=corpus["lexicon"],
                 rundir=os.path.join(root, "runs"), runname="cpc", nthread=2, seed=0)
    alternate = dict(unsupdates=1, supdates=1)  # CPC flags: one update of each in turn
    per_update = expected_launches(CPC_SPEC, 1, 0)
    laps = {}

    # the first batch, card against CPU: the same seeded weights on both
    nodrop = _cut_arch(CPC_ARCHS[1], os.path.join(root, "context_nodrop.arch"))
    cfg = Config.from_sources(argv=_argv(dict(
        flags, train=check_lst, train2=check_lst, batchsize=CPC_CHECK_UTTS, rundir="",
        runname="", arch=",".join([CPC_ARCHS[0], nodrop, CPC_ARCHS[2]]))))
    card, cpu = (CPCTrainer(cfg, cpc_flags=alternate, device=d) for d in ("cuda", "cpu"))
    n_params = sum(p.numel() for p in card.net.parameters())
    log(f"[cpc] phase 20: {n_params} parameters (encoder, context, predict, criterion) | "
        f"{smi_line}")
    ds = card.unsup_ds
    batch = pad_batch_rows(ds.materialize(ds.batch_specs(shuffle_seed=cfg.seed)[0]), 1)
    kernels.reset_launches()
    t0 = time.perf_counter()
    loss_c, _, draws = card.unsup_step(batch, 0.0, 7)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    card_launches("cpc first batch", per_update)
    g_card = _grads(card.net)
    t0 = time.perf_counter()
    loss_p = cpu.unsup_step(batch, 0.0, 7, draws={k: v.cpu() for k, v in draws.items()})[0]
    cpu_s = time.perf_counter() - t0
    errs = _leaf_errors(g_card, _grads(cpu.net), {})
    worst = sorted(errs, key=errs.get, reverse=True)
    first = dict(batch=list(batch["audio"].shape), loss_card=loss_c, loss_cpu=loss_p,
                 loss_rel_err=abs(loss_c - loss_p) / abs(loss_p), n_leaves=len(errs),
                 card_s=card_s, cpu_s=cpu_s,
                 worst_leaves=[dict(name=k, rel_l2=errs[k]) for k in worst[:3]])
    first["ok"] = bool(math.isfinite(loss_c) and first["loss_rel_err"] <= CARD_CPU_TOL[0]
                       and errs[worst[0]] <= CARD_CPU_TOL[1])
    log(f"[cpc first batch] {json.dumps(first)}")
    if not first["ok"]:
        fail(f"cpc: the first batch's loss or gradients on the card differ from the CPU: "
             f"{json.dumps(first)}")
    del card, cpu
    torch.cuda.empty_cache()
    laps["first_batch"] = time.perf_counter() - t_phase

    # 2 unsupervised and 2 supervised updates, continue for 1, pretrainmodel
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with _Calls((CPCTrainer, "unsup_step"), (CPCTrainer, "sup_step")) as rec:
        tr = cpc_main(["train"] + _argv(dict(flags, **alternate)) + ["--iter=4"])
    launches, names = rec.held("cpc training", {"unsup_step": per_update,
                                                "sup_step": per_update})
    phases = [c["name"] for c in rec.calls]
    if phases != ["unsup_step", "sup_step"] * 2 or tr.updates != 4:
        fail(f"cpc: updates {tr.updates}, phases {phases}")
    ends = [c["end"] for c in rec.calls]
    train = dict(updates=4, phases=phases, losses=[c["loss"] for c in rec.calls],
                 s_per_update=(ends[-1] - ends[0]) / 3, launches=launches,
                 peak_mem_gib_training=torch.cuda.max_memory_allocated() / 2**30)
    largest = max(tr.unsup_ds.batch_specs(), key=lambda sp: sp.max_input_frames)
    big = pad_batch_rows(tr.unsup_ds.materialize(largest), 1)
    convs, lns, restore = _kernel_shapes()  # one update's calls, at the largest batch
    try:
        tr.unsup_step(big, 0.0, 99)
    finally:
        restore()
    train["update"] = dict(batch=list(big["audio"].shape),
                           **step_numbers(lambda: tr.unsup_step(big, 0.0, 99)))
    del tr
    torch.cuda.empty_cache()
    laps["train"] = time.perf_counter() - t_phase
    with _Calls((CPCTrainer, "unsup_step"), (CPCTrainer, "sup_step")) as rec:
        tr = cpc_main(["continue"] + _argv(dict(flags, **alternate)) + ["--iter=5"])
    rec.held("cpc continue", {"unsup_step": per_update, "sup_step": per_update})
    last = os.path.join(flags["rundir"], "cpc", "model_last.bin")
    ckpt = load_checkpoint(last)
    if tr.updates != 5 or ckpt.updates != 5 or [c["name"] for c in rec.calls] != ["unsup_step"]:
        fail(f"cpc continue: updates {tr.updates}/{ckpt.updates}, "
             f"{[c['name'] for c in rec.calls]}")
    del tr
    cfg = Config.from_sources(argv=_argv(dict(flags, runname="cpc_pretrained", iter=1)))
    tr = CPCTrainer(cfg, cpc_flags=dict(alternate, pretrainmodel=last), device="cuda")
    same = all(torch.equal(v.cpu(), ckpt.state_dict[k]) for k, v in tr.net.state_dict().items())
    with _Calls((CPCTrainer, "unsup_step"), (CPCTrainer, "sup_step")) as rec:
        tr.run()
    rec.held("cpc pretrained", {"unsup_step": per_update, "sup_step": per_update})
    if not same or tr.updates != 1:
        fail(f"cpc --pretrainmodel: weights loaded {same}, updates {tr.updates}")
    del tr
    torch.cuda.empty_cache()
    laps["continue_pretrain"] = time.perf_counter() - t_phase

    # the path's kernels at the largest batch's shapes (fp32: CPC trains fp32)
    if len(convs) != 1 or len(lns) != 12 or len(set(lns)) != 1:
        fail(f"cpc: one forward's K2 calls {convs}, K3 calls {lns}")
    details = []
    rows = {"time_conv": check_time_conv(convs, "float32", details),
            "time_conv_wgrad": check_time_conv_backward(convs, "float32",
                                                        details)["time_conv_wgrad"],
            "residual_ln": check_residual_ln(lns, "float32", details),
            "residual_ln_bwd": check_residual_ln_bwd(lns, "float32", details)}
    bad = [r for r in details if not r["ok"]]
    if bad:
        fail(f"cpc: {len(bad)} kernel checks disagree with the plain versions: "
             f"{json.dumps(bad[0])}")
    laps["kernels"] = time.perf_counter() - t_phase
    out = dict(n_params=n_params, audio_s=secs, first_batch=first, training=train,
               kernel_rows={k: [{kk: r[kk] for kk in ("name", "dtype", "shape", "calls", "ms",
                                                        "plain_ms", "library_ms", "bound_ms",
                                                        "bound_by", "max_abs_err")}
                                for r in v] for k, v in rows.items()},
               laps_s=laps, nvidia_smi=smi_line)
    log(f"[cpc] {json.dumps(dict(training=train, laps=laps))} | {smi_line}")
    return out


def slimipl_semi(root, corpus, smi_line):
    """``recipes/slimipl/train.cfg`` (the flagship at full width, B = 16) on
    phase 13's shortest utterances, the list both ``--train`` and
    ``--train2`` (its transcripts meter the PLs' quality), through
    ``cli.train_slimipl`` with ``--slimIPL_start=2``: type ``cache``, then
    ``fixed-pre-cache`` with the EMA and soft labels (a fixed cache of 2
    batches), ``SLIM_UPDATES`` updates each; every model update's launches
    held to phase 6's (1 K1, 15 K2 + 14 dgrad, 15 K2b, 22 K3, 22 K3b) and every
    PL generation's to a forward's (1 K1, 15 K2, 22 K3); then ``continue``
    with the caches (and the EMA) restored in equal bits, for one update; one
    steady update's numbers."""
    import numpy as np
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.cli.train_slimipl import main as slim_main
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data.batching import pad_batch_rows
    from wav2letter_tpu_torch.runtime.train import Trainer
    from wav2letter_tpu_torch.runtime.train_slimipl import SlimIPLTrainer

    t_phase = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    lst, secs = shortest(corpus["train"], os.path.join(root, "train.lst"), SLIM_UTTS)
    flags = dict(flagsfile=SLIM_CFG, arch=ARCH, train=lst, train2=lst,
                 tokens=corpus["tokens"], lexicon=corpus["lexicon"],
                 rundir=os.path.join(root, "runs"), nthread=2, seed=0,
                 iter=SLIM_UPDATES, reportiters=0, slimIPL_start=2, **FLAGSHIP["flags"])
    expect = {"train_step": expected_launches(FLAGSHIP, 1, 0),
              "soft_step": expected_launches(FLAGSHIP, 1, 0),
              "_pl_forward": expected_launches(FLAGSHIP, 0, 1)}
    targets = ((Trainer, "train_step"), (SlimIPLTrainer, "soft_step"),
               (SlimIPLTrainer, "_pl_forward"))
    out, laps = {}, {}
    for name, extra in (("cache", dict(slimIPL_type="cache")),
                        ("fixed_soft_ema", dict(slimIPL_type="fixed-pre-cache",
                                                slimIPL_fixed_cache_updates=2,
                                                slimIPL_ema="true", slimIPL_use_soft="true"))):
        argv = _argv(dict(flags, runname=name, **extra))
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with _Calls(*targets) as rec:
            tr = slim_main(["train"] + argv)
        launches, calls = rec.held(f"slimIPL {name}", expect)
        if tr.updates != SLIM_UPDATES or not calls.get("_pl_forward") \
                or calls.get("train_step", 0) + calls.get("soft_step", 0) < 3 \
                or (name != "cache" and not calls.get("soft_step")):
            fail(f"slimIPL {name}: updates {tr.updates}, calls {calls}")
        run = dict(calls=calls, launches=launches, losses=[c["loss"] for c in rec.calls
                                                           if c["loss"] is not None],
                   cache=len(tr.cache), soft_cache=len(tr.soft_cache),
                   fixed_cache=list(tr.fixed_cache), pl_quality_wer=tr.pl_quality.error_rate(),
                   peak_mem_gib_training=torch.cuda.max_memory_allocated() / 2**30)
        if name == "cache":
            largest = max(tr.train_ds.batch_specs(), key=lambda sp: sp.max_input_frames)
            run["update"] = update_numbers(tr, pad_batch_rows(tr.train_ds.materialize(largest),
                                                              1))
        saved = (dict(tr.cache), {k: v.copy() for k, v in tr.soft_cache.items()},
                 list(tr.fixed_cache), tr._cache_hits, tr._label_cursor,
                 None if tr.ema_model is None else [p.detach().cpu().clone() for p in
                                                   tr.ema_model.parameters()])
        del tr
        torch.cuda.empty_cache()
        # continue: the caches come back as the run left them, then one update
        cfg = Config.from_sources(argv=[f"--rundir={flags['rundir']}", f"--runname={name}",
                                        f"--iter={SLIM_UPDATES + 1}"])
        ipl_flags = {k: v for k, v in dict(flags, **extra).items() if k.startswith("slimIPL")}
        ipl_flags = {k: (v == "true" if v in ("true", "false") else v)
                     for k, v in ipl_flags.items()}
        tr = SlimIPLTrainer(cfg, ipl_flags=ipl_flags, mode="continue", device="cuda")
        ema = None if tr.ema_model is None else [p.detach().cpu() for p in
                                                 tr.ema_model.parameters()]
        same = (tr.cache == saved[0] and sorted(tr.soft_cache) == sorted(saved[1])
                and all(tr.soft_cache[k].dtype == v.dtype and np.array_equal(tr.soft_cache[k], v)
                        for k, v in saved[1].items())
                and (list(tr.fixed_cache), tr._cache_hits, tr._label_cursor) == saved[2:5]
                and (ema is None) == (saved[5] is None)
                and (ema is None or all(torch.equal(a, b) for a, b in zip(ema, saved[5]))))
        with _Calls(*targets) as rec:
            tr.run()
        rec.held(f"slimIPL {name} continue", expect)
        if not same or tr.updates != SLIM_UPDATES + 1:
            fail(f"slimIPL {name} continue: caches restored {same}, updates {tr.updates}")
        run["continued"] = dict(restored=dict(cache=len(saved[0]), soft_cache=len(saved[1]),
                                              fixed_cache=saved[2], ema=saved[5] is not None),
                                calls=[c["name"] for c in rec.calls])
        del tr
        torch.cuda.empty_cache()
        out[name] = run
        laps[name] = time.perf_counter() - t_phase
        log(f"[slimipl {name}] {json.dumps(run)}")
    out.update(laps_s=laps, nvidia_smi=smi_line, audio_s=secs)
    return out


def _greedy_ties(card, cpu, batch, proposals):
    """The card's proposals (fp32) step by step on the CPU copy of the
    proposal decoder, over the card's encoder states: a row may part from the
    CPU's greedy choice only at a step whose top-2 margin there is within
    ``S2S_TIE`` (counted), and each row's proposal is the card's greedy path."""
    import torch

    from wav2letter_tpu_torch.data.batching import pad_batch_rows

    b = card._to_device(pad_batch_rows(batch, 1))
    with torch.no_grad():
        feats, flen = card.featurizer(b["audio"], b["audio_len"])
        em, elen = card.proposal_model(feats.float(), flen)
        toks, lens = (t.cpu() for t in card.proposal_crit.greedy_path(em.float(), elen))
        em, elen = em.float().cpu(), elen.cpu()
        crit, c = cpu.proposal_crit, cpu.proposal_crit.cfg
        B, T = em.shape[:2]
        mask = torch.arange(T)[None, :] < elen[:, None]
        state, prev = crit.init_state(B), torch.full((B,), c.eos_idx)
        parted, ties, compared = [False] * B, 0, 0
        for u in range(min(int(lens.max()) + 1, toks.shape[1]) if lens.numel() else 0):
            state, lg = crit.decode_step(state, prev, em, mask, u)
            best = lg.argmax(dim=-1)
            for i in range(B):
                if not parted[i] and u <= int(lens[i]):
                    compared += 1
                    if int(best[i]) != int(toks[i, u]):
                        margin = (lg[i, best[i]] - lg[i, int(toks[i, u])]).item()
                        if margin > S2S_TIE:
                            fail(f"lpm: proposal token {u} of row {i}: card {int(toks[i, u])}, "
                                 f"CPU {int(best[i])}, margin {margin}")
                        parted[i], ties = True, ties + 1
            prev = toks[:, u].long()
    paths = [[int(t) for t in toks[i, : int(lens[i])]] for i in range(B)]
    if [h[0] if h else [] for h, _ in proposals] != paths:
        fail(f"lpm: the proposals are not the card's greedy paths: {proposals}, {paths}")
    return dict(greedy_steps_compared=compared, greedy_ties=ties)


def lpm_semi(root, corpus, smi_line):
    """``recipes/local_prior_match/train.cfg`` (``seq2seq_tds``, with
    ``LPM_FIX``: the recipe sets neither its features nor ``--encoderdim``) on
    phase 13's shortest utterances (letters), the list both paired and
    unpaired, phase 13's 3-gram as the prior: one unpaired batch's proposals
    (the 4 shortest, fp32) card against CPU on the same seeded weights, a
    row parting only at a tie (``_greedy_ties``); then 2
    paired and 2 unpaired updates with ``--propupdate=2`` through
    ``cli.train_lpm``, each update's launches held to phase 16's and each
    proposal's to an encoder forward's (1 K1, 14 K2), the proposal refreshed
    after updates 2 and 4; one steady update's numbers."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.cli.train_lpm import main as lpm_main
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data.batching import pad_batch_rows
    from wav2letter_tpu_torch.runtime.train import Trainer
    from wav2letter_tpu_torch.runtime.train_lpm import LPMTrainer

    t_phase = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    lst, secs = shortest(corpus["train"], os.path.join(root, "train.lst"), LPM_UTTS)
    flags = dict(flagsfile=LPM_CFG, arch=os.path.join(REPO, "recipes", "seq2seq_tds",
                                                      "network.arch"),
                 train=lst, train2=lst, tokens=corpus["tokens"], lexicon=corpus["lexicon"],
                 lm=corpus["lm"], rundir=os.path.join(root, "runs"), runname="lpm",
                 nthread=2, seed=0, **S2S_LETTERS, **LPM_FIX)
    per_update, per_prop = expected_launches(LPM_SPEC, 1, 0), expected_launches(LPM_SPEC, 0, 1)
    laps = {}
    cfg = Config.from_sources(argv=_argv(dict(flags, compute_dtype="float32")))
    fl = dict(unpairedBatchsize=LPM_CHECK_UTTS)
    card = LPMTrainer(cfg, lpm_flags=fl, device="cuda")
    cpu = LPMTrainer(cfg, lpm_flags=fl, device="cpu")
    ds = card.unpaired_ds
    spec = min(ds.batch_specs(), key=lambda sp: sp.max_input_frames)
    batch = ds.materialize(spec)
    kernels.reset_launches()
    got = card._propose(batch)
    card_launches("lpm proposal", per_prop)
    t0 = time.perf_counter()
    want = cpu._propose(batch)
    cpu_s = time.perf_counter() - t0
    prop = dict(batch=list(batch["audio"].shape), tokens=[len(h[0]) if h else 0 for h, _ in got],
                cpu_s=cpu_s, rows_equal=sum(g == w for g, w in zip(got, want)),
                **_greedy_ties(card, cpu, batch, got))
    log(f"[lpm proposals] {json.dumps(prop)}")
    del card, cpu
    torch.cuda.empty_cache()
    laps["proposals"] = time.perf_counter() - t_phase
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with _Calls((Trainer, "train_step"), (LPMTrainer, "_proposal_tokens")) as rec:
        tr = lpm_main(["train"] + _argv(flags) + ["--iter=4", "--propupdate=2"])
    launches, calls = rec.held("lpm training", {"train_step": per_update,
                                                "_proposal_tokens": per_prop})
    if tr.updates != 4 or calls != {"train_step": 4, "_proposal_tokens": 2} \
            or tr.refreshed_at != [2, 4]:
        fail(f"lpm: updates {tr.updates}, calls {calls}, refreshed {tr.refreshed_at}")
    ends = [c["end"] for c in rec.calls if c["name"] == "train_step"]
    largest = max(tr.train_ds.batch_specs(), key=lambda sp: sp.max_input_frames)
    run = dict(updates=4, calls=calls, launches=launches, refreshed_at=tr.refreshed_at,
               losses=[c["loss"] for c in rec.calls if c["loss"] is not None],
               s_per_update=(ends[-1] - ends[0]) / 3,
               peak_mem_gib_training=torch.cuda.max_memory_allocated() / 2**30,
               update=update_numbers(tr, pad_batch_rows(tr.train_ds.materialize(largest), 1)))
    del tr
    torch.cuda.empty_cache()
    laps["train"] = time.perf_counter() - t_phase
    log(f"[lpm] {json.dumps(run)}")
    return dict(proposals=prop, training=run, audio_s=secs, laps_s=laps, nvidia_smi=smi_line)


def ipl_semi(root, corpus, smi_line):
    """``cli.ipl`` on the flagship at full width (phase 6's training flags,
    B = 16) on phase 13's shortest training utterances, its shortest test
    utterances unlabeled: a seed round of 2 updates, then one round of 2 whose
    PLs come from the native lexicon beam with phase 13's 3-gram, stopped once
    the round's PLs are written and resumed from ``ipl_state.json`` (the PLs
    written again, equal); every update's and every forward's launches held;
    one steady update's numbers."""
    import torch

    import wav2letter_tpu_torch.runtime.ipl as ipl
    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.cli.ipl import main as ipl_main
    from wav2letter_tpu_torch.data.batching import pad_batch_rows
    from wav2letter_tpu_torch.runtime.test import Evaluator
    from wav2letter_tpu_torch.runtime.train import Trainer

    os.environ.setdefault("W2L_REQUIRE_NATIVE", "1")
    t_phase = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    train_lst, _ = shortest(corpus["train"], os.path.join(root, "train.lst"), IPL_TRAIN_UTTS)
    unsup_lst, unsup_secs = shortest(corpus["test"], os.path.join(root, "unsup.lst"),
                                     IPL_UNSUP_UTTS)
    flags = dict(arch=ARCH, criterion="ctc", mfsc=True, filterbanks=N_FEAT, onorm="target",
                 sqnorm=True, compute_dtype="bfloat16", train=train_lst,
                 tokens=corpus["tokens"], lexicon=corpus["lexicon"], rundir=root,
                 runname="ipl", nthread=2, seed=0, reportiters=0, lm=corpus["lm"],
                 lmweight=1.0, wordscore=0.5, beamsize=50, beamsizetoken=10,
                 beamthreshold=25, smearing="max", **FLAGSHIP["flags"], **FLAGSHIP["train"])
    argv = _argv(flags) + [f"--unsup_train={unsup_lst}", "--ipl_rounds=1",
                           "--ipl_seed_iters=2", "--ipl_round_iters=2",
                           "--ipl_max_ngram_repeats=100"]
    expect = {"train_step": expected_launches(FLAGSHIP, 1, 0),
              "emissions": expected_launches(FLAGSHIP, 0, 1)}
    targets = ((Trainer, "train_step"), (Evaluator, "emissions"))
    write = ipl.write_pseudo_labeled_list

    class Stop(Exception):
        pass

    def write_then_stop(*a):
        n = write(*a)
        raise Stop(n)

    kernels.reset_launches()
    ipl.write_pseudo_labeled_list = write_then_stop
    try:
        with _Calls(*targets) as rec:
            ipl_main(argv)
        fail("ipl: the loop did not reach the round's pseudo-labels")
    except Stop as e:
        n_pl = e.args[0]
    finally:
        ipl.write_pseudo_labeled_list = write
    first, first_calls = rec.held("ipl to the PLs", expect)
    run = os.path.join(root, "ipl")
    with open(os.path.join(run, "ipl_state.json")) as f:
        state = json.load(f)
    with open(os.path.join(run, "pl_round01.lst")) as f:
        pls = f.read()
    if state["round"] != 1 or first_calls.get("train_step") != 2 \
            or not first_calls.get("emissions"):
        fail(f"ipl: state {state}, calls {first_calls}")
    t0 = time.perf_counter()
    with _Calls(*targets) as rec:
        state = ipl_main(argv)
    resume_s = time.perf_counter() - t0
    second, second_calls = rec.held("ipl resumed", expect)
    with open(os.path.join(run, "pl_round01.lst")) as f:
        same = f.read() == pls
    if state["round"] != 2 or second_calls.get("train_step") != 2 or not same:
        fail(f"ipl resumed: state {state}, calls {second_calls}, PLs equal {same}")
    tr = [c["obj"] for c in rec.calls if c["name"] == "train_step"][-1]
    largest = max(tr.train_ds.batch_specs(), key=lambda sp: sp.max_input_frames)
    update = update_numbers(tr, pad_batch_rows(tr.train_ds.materialize(largest), 1))
    del tr, rec
    torch.cuda.empty_cache()
    out = dict(n_pl=n_pl, unsup_utts=IPL_UNSUP_UTTS, unsup_audio_s=unsup_secs,
               to_pls=dict(calls=first_calls, launches=first),
               resumed=dict(calls=second_calls, launches=second, wall_s=resume_s,
                            pls_equal=same),
               history=state["history"], update=update,
               phase_s=time.perf_counter() - t_phase, nvidia_smi=smi_line)
    log(f"[ipl] {json.dumps(out)}")
    return out


def semi_path(tmp, corpus, smi_line):
    """Phase 20: CPC, slimIPL, LPM and IPL at full width (``cpc_semi``,
    ``slimipl_semi``, ``lpm_semi``, ``ipl_semi``)."""
    t_phase = time.perf_counter()
    root = os.path.join(tmp, "semi")
    out, laps = {}, {}
    for name, fn in (("cpc", cpc_semi), ("slimipl", slimipl_semi), ("lpm", lpm_semi),
                     ("ipl", ipl_semi)):
        out[name] = fn(os.path.join(root, name), corpus, smi_line)
        laps[name] = time.perf_counter() - t_phase
    out.update(laps_s=laps, phase_s=time.perf_counter() - t_phase)
    log(f"[semi] phase 20 in {out['phase_s']:.1f} s (laps {json.dumps(laps)}) | {smi_line}")
    return out


# ---------------------------------------------------------------------------
# phase 21: the tools, the flashlight reader and CPC on two ranks
# ---------------------------------------------------------------------------
# prod_scale's LM corpus, cut from the JAX default of 24,000,000 tokens so that
# the build stays well inside the phase (a 200k-word pass of every lexicon word
# comes on top); the full size is ``python -m wav2letter_tpu_torch.tools.
# prod_scale --root DIR``
PROD_LM_TOKENS = 200_000
PROD_DECODE_UTTS = 8
PROD_DECODE_FLAGS = ["--batchsize=4", "--beamsize=100", "--beamthreshold=25", "--lmweight=1",
                     "--wordscore=0.5", "--smearing=max", "--nthread_decoder=1"]
WP_UTTS, WP_VOCAB, WP_UPDATES = 16, 64, 2  # the wordpiece chain: utterances, pieces, updates
# CPC on two gloo ranks against one process at the global batch: the recipe's
# archs at full width, the context's dropout and layerdrop 0 (each rank draws
# its own rows' masks), fp32; adam's epsilon 1e-4 as in tests/test_torch_cpc.py,
# since the attention's key bias has a gradient of exactly 0 that both sides
# compute as rounding noise, which adam's default epsilon turns into steps of
# either sign. Loss (relative) and the parameters' distance from one process
# as a share of the distance they moved, over the whole net.
CPC_DP_RANKS, CPC_DP_BATCH = 2, 4  # ranks, rows a rank (B = 8 in all)
CPC_DP_TOL = (1e-5, 1e-3)
FL_PARTS = {"C2": ("",), "LN": ("",), "L": ("",),
            "TDS": ("conv.", "ln1.", "lin1.", "lin2.", "ln2.")}


def forge_flashlight(path, state, arch_path, gflags, noise=b"\x07\x00xyz"):
    """``state`` (the port's state dict of ``arch_path``) as a flashlight
    training checkpoint, the layout ``tests/util_torch_flashlight.py`` forges:
    the version string, a cfg map holding ``gflags``, then each param as an
    AF array (dims reversed, column-major) after ``noise``, in the reference
    converter's ``params()`` order. Returns the bytes written."""
    import struct

    import numpy as np

    def string(s):
        b = s.encode()
        return struct.pack("<Q", len(b)) + b

    with open(arch_path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.strip().startswith("#")]
    n = 0
    with open(path, "wb") as f:
        f.write(string("0.3") + struct.pack("<Q", 1) + string("gflags") + string(gflags))
        for i, line in enumerate(lines):
            kind = line.split()[0]
            for part in FL_PARTS.get(kind, ()):
                for leaf in ("weight", "bias"):
                    a = np.ascontiguousarray(
                        state[f"seq.{i:02d}_{kind}.{part}{leaf}"].float().numpy())
                    dims = tuple(reversed(a.shape)) + (1,) * (4 - a.ndim)
                    f.write(noise + struct.pack("<4q", *dims) + struct.pack("<I", 0)
                            + struct.pack("<Q", a.nbytes) + a.tobytes())
                    n += a.size
        f.write(noise)
    return n


def _test_run(argv, sclite, em_dir, want):
    """``cli.test`` on ``argv`` with ``--sclite`` and ``--emission_dir``,
    its launches held to ``want``: (result, hypotheses, seconds)."""
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.cli.test import main as test_main

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = test_main(argv + [f"--sclite={sclite}", f"--emission_dir={em_dir}"])
    torch.cuda.synchronize()
    card_launches(f"cli.test {argv[0]}", want)
    lst = [a.split("=", 1)[1] for a in argv if a.startswith("--test=")][0]
    return res, read_hyps(sclite, lst), time.perf_counter() - t0


def flashlight_tools(root, paths, lst, secs, arpa, hyps10, n_batches, smi_line):
    """Phase 21 (a): phase 4's flagship checkpoints (bf16 and fp32) as
    flashlight checkpoints (``forge_flashlight``, their gflags the
    checkpoints' flags) through ``cli.test`` (emissions equal in bits to the port's
    checkpoint's, the same hypotheses and WER, 1 K1, 15 K2, 22 K3 a batch),
    ``cli.decode`` with phase 10's 3-gram (phase 10's fp32 words), and
    ``cli.convert_streaming`` then one utterance streamed (every chunk's
    output equal in bits to the stream of the port's checkpoint's bundle)."""
    import numpy as np
    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.cli import convert_streaming, streaming_asr
    from wav2letter_tpu_torch.cli.decode import main as decode_main
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data import read_list_file
    from wav2letter_tpu_torch.data.audio import load_audio
    from wav2letter_tpu_torch.inference import load_streaming_bundle
    from wav2letter_tpu_torch.runtime.checkpoint import load_checkpoint

    os.makedirs(root, exist_ok=True)
    # one file a type: --compute_dtype is a training flag, read from the
    # checkpoint's flags as the port's own checkpoints carry it
    fls, out, cfg = {}, {}, None
    for dt in ("bfloat16", "float32"):
        ckpt = load_checkpoint(paths[dt])
        cfg = Config.deserialize(ckpt.config)
        fls[dt] = os.path.join(root, f"fl_{dt}.bin")
        t0 = time.perf_counter()
        n = forge_flashlight(fls[dt], ckpt.state_dict, cfg.arch,
                             "\n".join(f"--{k}={v}" for k, v in cfg.asdict().items()) + "\n")
        forge_s = time.perf_counter() - t0
        if n != FLAGSHIP["n_params"]:
            fail(f"flashlight: forged {n} parameters, expected {FLAGSHIP['n_params']}")
        mb = os.path.getsize(fls[dt]) / 1e6
        t0 = time.perf_counter()
        got = load_checkpoint(fls[dt])
        load_s = time.perf_counter() - t0
        if got.extra.get("flashlight_version") != "0.3" or got.config != ckpt.config or set(
                got.state_dict) != set(ckpt.state_dict) or not all(
                    torch.equal(got.state_dict[k], v) for k, v in ckpt.state_dict.items()):
            fail(f"flashlight {dt}: load_checkpoint of the forged file differs from the port's "
                 "checkpoint")
        log(f"[flashlight {dt}] forged {n} parameters, {mb:.1f} MB in {forge_s:.2f} s; "
            f"load_checkpoint (header, scan, arch walk, conversion) {load_s:.2f} s | {smi_line}")
        del got, ckpt
        out[dt] = dict(n_params=n, mb=mb, forge_s=forge_s, load_s=load_s)
    fl = fls["float32"]
    serve = expected_launches(FLAGSHIP, 0, n_batches)
    base = [f"--test={lst}", f"--batchsize={BATCH}"]
    for dt in ("bfloat16", "float32"):
        own = _test_run([f"--am={paths[dt]}"] + base, os.path.join(root, dt, "own"),
                        os.path.join(root, dt, "own_em"), serve)
        mine = _test_run([f"--am={fls[dt]}"] + base, os.path.join(root, dt, "fl"),
                         os.path.join(root, dt, "fl_em"), serve)
        unequal = []
        for s in read_list_file(lst):
            a, b = (np.load(os.path.join(root, dt, d, f"{s.sample_id}.npz"))["emission"]
                    for d in ("own_em", "fl_em"))
            if a.shape != b.shape or not np.array_equal(a, b):
                unequal.append(s.sample_id)
        row = dict(WER=mine[0]["WER"], TER=mine[0]["TER"], own_WER=own[0]["WER"],
                   own_TER=own[0]["TER"], test_s=mine[2], own_test_s=own[2], launches=serve,
                   emissions_equal=not unequal)
        log(f"[flashlight cli.test {dt}] {json.dumps(row)}")
        if unequal or mine[1] != own[1] or (mine[0]["WER"], mine[0]["TER"]) != (
                own[0]["WER"], own[0]["TER"]):
            fail(f"flashlight {dt}: cli.test differs from the port's checkpoint: emissions "
                 f"of {unequal}, hypotheses equal {mine[1] == own[1]}")
        out[dt].update(row)

    os.environ["W2L_REQUIRE_NATIVE"] = "1"
    runs = {}
    for name, am in (("fl", fl),) + ((("own", paths["float32"]),) if hyps10 is None else ()):
        d = os.path.join(root, "decode_" + name)
        torch.cuda.synchronize()
        kernels.reset_launches()
        res = decode_main([f"--am={am}", f"--test={lst}", f"--lm={arpa}", *DECODE_FLAGS,
                           f"--sclite={d}"])
        torch.cuda.synchronize()
        card_launches(f"flashlight cli.decode {name}", serve)
        runs[name] = dict(WER=res["WER"], wall_s=res["wall_s"], setup_s=res["setup_s"],
                          hyps=read_hyps(d, lst))
    want = hyps10 if hyps10 is not None else runs["own"]["hyps"]
    if runs["fl"]["hyps"] != want:
        fail("flashlight: cli.decode of the forged file decodes otherwise than phase 10")
    out["decode"] = dict(WER=runs["fl"]["WER"], wall_s=runs["fl"]["wall_s"],
                         setup_s=runs["fl"]["setup_s"], audio_s_per_wall_s=secs / (
                             runs["fl"]["wall_s"] - runs["fl"]["setup_s"]),
                         words_equal_phase10=True, phase10_in_this_run=hyps10 is not None)
    log(f"[flashlight cli.decode float32] {json.dumps(out['decode'])}")

    streams, meta = {}, None
    opts = os.path.join(root, "decoder.json")
    with open(opts, "w") as f:
        json.dump(STREAM_DECODER, f)
    shortest_utt = min(read_list_file(lst), key=lambda s: s.duration_ms)
    for name, am in (("own", paths["float32"]), ("fl", fl)):
        bundle = os.path.join(root, f"{name}.stream")
        with contextlib.redirect_stdout(io.StringIO()):
            convert_streaming.main([f"--am={am}", f"--out={bundle}"])
        net, featp, meta = load_streaming_bundle(bundle, "cuda")
        dec, word_dict, tok_dict, blank = streaming_asr.build_decoder(
            {"lexicon_file": cfg.lexicon, "language_model_file": arpa,
             "decoder_options_file": opts}, meta)
        audio = load_audio(shortest_utt.audio_path, featp.sample_rate)
        r = stream_one(net, featp, audio, dec)
        streams[name] = dict(r, words=streaming_asr.result_words(
            r["result"], word_dict, tok_dict, blank, str(meta["wordseparator"])))
        del net
    a, b = streams["own"], streams["fl"]
    same = (a["cut"] == b["cut"] and a["tail"] == b["tail"] and np.array_equal(a["em"], b["em"])
            and torch.equal(a["feats"], b["feats"]) and a["words"] == b["words"])
    out["stream"] = dict(utterance=shortest_utt.sample_id, chunks=len(a["cut"]),
                         frames=int(len(a["em"])), words=len(a["words"]), bit_equal=same)
    log(f"[flashlight stream] {json.dumps(out['stream'])}")
    if not same:
        fail("flashlight: the stream of the forged file's bundle differs from the port's")
    torch.cuda.empty_cache()
    return out


def prod_scale_tools(root, corpus, am, smi_line):
    """Phase 21 (b): ``build_prod_artifacts`` (200k words, a 4-gram of
    ``PROD_LM_TOKENS`` tokens) and ``cli.decode`` of phase 13's flagship on
    ``PROD_DECODE_UTTS`` test utterances with the 200k lexicon and the
    probing ``.bin``, the ``.qt`` and the ARPA (the native NgramLM): the
    ``.bin``'s words the ARPA's, every word in the lexicon (but in a
    hypothesis where the beam completed no word, which the decode spells
    from its tokens)."""
    import resource

    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.cli.decode import main as decode_main
    from wav2letter_tpu_torch.runtime import decode as decode_module
    from wav2letter_tpu_torch.tools.prod_scale import build_prod_artifacts

    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    art = build_prod_artifacts(os.path.join(root, "prod"), n_lexicon=200_000,
                               lm_tokens=PROD_LM_TOKENS, order=4)
    build_s = time.perf_counter() - t0
    with open(art["manifest"]) as f:
        manifest = json.load(f)
    rss_build = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    log(f"[prod_scale] manifest {json.dumps(manifest)}; built in {build_s:.1f} s, peak host "
        f"RSS {rss_build:.2f} GiB | {smi_line}")
    with open(art["lexicon"]) as f:
        lexicon_words = {line.split("\t", 1)[0] for line in f}
    with open(corpus["test"]) as f:
        rows = [line for line in f if line.strip()][:PROD_DECODE_UTTS]
    lst = os.path.join(root, "test8.lst")
    with open(lst, "w") as f:
        f.writelines(rows)
    secs = sum(float(r.split()[2]) for r in rows) / 1000.0
    os.environ["W2L_REQUIRE_NATIVE"] = "1"
    n_batches = -(-len(rows) // 4)
    serve = expected_launches(FLAGSHIP, 0, n_batches)
    setups, build = [], decode_module.build_decoder

    def timed_build(*a, **kw):
        t = time.perf_counter()
        res = build(*a, **kw)
        setups.append(time.perf_counter() - t)
        return res

    runs = {}
    decode_module.build_decoder = timed_build
    try:
        for key in ("bin", "qt", "arpa"):
            d = os.path.join(root, key)
            setups.clear()
            torch.cuda.synchronize()
            kernels.reset_launches()
            res = decode_main([f"--am={am}", f"--test={lst}", f"--lexicon={art['lexicon']}",
                               f"--lm={art[key]}", *PROD_DECODE_FLAGS, f"--sclite={d}"])
            torch.cuda.synchronize()
            launches = card_launches(f"prod_scale decode {key}", serve)
            hyps = read_hyps(d, lst)
            runs[key] = dict(WER=res["WER"], decoder=res["decoder"], setup_am_s=res["setup_s"],
                             setup_decoder_s=list(setups), wall_s=res["wall_s"],
                             forward_s=res["forward_s"], beam_s=res["beam_s"],
                             audio_s_per_wall_s=secs / res["wall_s"],
                             launches_per_batch={k: v // n_batches for k, v in launches.items()},
                             peak_rss_gib=resource.getrusage(
                                 resource.RUSAGE_SELF).ru_maxrss / 2**20,
                             hyps=hyps)
            # a hypothesis in which the beam completed no word is spelled from
            # its tokens (``result_to_words``, as JAX and the reference do):
            # none of its words is then the lexicon's; every other hypothesis
            # holds the lexicon's words alone
            inside = {sid: [w in lexicon_words for w in ws] for sid, ws in hyps.items()}
            mixed = [sid for sid, v in inside.items() if any(v) and not all(v)]
            runs[key]["spelled_utterances"] = sum(1 for v in inside.values() if v and not any(v))
            runs[key]["words_in_lexicon"] = sum(sum(v) for v in inside.values())
            if res["decoder"] != "NativeBeamDecoder" or mixed:
                fail(f"prod_scale decode {key}: decoder {res['decoder']}, words outside the "
                     f"lexicon beside its words in {mixed}")
            log(f"[prod_scale decode {key}] "
                f"{json.dumps({k: v for k, v in runs[key].items() if k != 'hyps'})}")
    finally:
        decode_module.build_decoder = build
    if runs["bin"]["hyps"] != runs["arpa"]["hyps"]:
        fail("prod_scale: the probing .bin decodes otherwise than the ARPA")
    runs["qt"]["words_equal_bin"] = runs["qt"]["hyps"] == runs["bin"]["hyps"]
    for r in runs.values():
        r.pop("hyps")
    return dict(manifest=manifest, build_s=build_s, lm_tokens=PROD_LM_TOKENS,
                peak_rss_gib_build=rss_build, utterances=len(rows), audio_s=secs, decode=runs,
                nvidia_smi=smi_line)


def wordpiece_tools(root, corpus, soak_flags, smi_line):
    """Phase 21 (c): phase 13's ``WP_UTTS`` shortest training utterances as a
    LibriSpeech tree, ``prepare_librispeech_split``, ``word_counts_from_lists``,
    ``UnigramWordPiece`` (``WP_VOCAB`` pieces) and its tokens and 2-best
    lexicon; ``cli.train --usewordpiece=true`` on the flagship at full width
    (its last layer over the pieces), ``WP_UPDATES`` bf16 updates at B = 16,
    each launching what phase 6 counts; then ``cli.test``."""
    import shutil

    import torch

    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.cli.test import main as test_main
    from wav2letter_tpu_torch.cli.train import main as train_main
    from wav2letter_tpu_torch.tools.data_prep import prepare_librispeech_split
    from wav2letter_tpu_torch.tools.wordpiece import UnigramWordPiece, word_counts_from_lists

    t0 = time.perf_counter()
    with open(corpus["train"]) as f:
        rows = sorted((float(l.split()[2]), l.split()) for l in f if l.strip())[:WP_UTTS]
    tree = os.path.join(root, "LibriSpeech")
    for i, (_, parts) in enumerate(rows):
        spk, chap = 100 + i // 8, 200 + i // 8
        d = os.path.join(tree, "train-clean-100", str(spk), str(chap))
        os.makedirs(d, exist_ok=True)
        uid = f"{spk}-{chap}-{i % 8:04d}"
        shutil.copy(parts[1], os.path.join(d, uid + ".wav"))
        with open(os.path.join(d, f"{spk}-{chap}.trans.txt"), "a") as f:
            f.write(f"{uid} {' '.join(parts[3:]).upper()}\n")
    lst = os.path.join(root, "train-clean-100.lst")
    n = prepare_librispeech_split(tree, "train-clean-100", lst)
    counts = word_counts_from_lists([lst])
    wp = UnigramWordPiece(vocab_size=WP_VOCAB, max_piece_len=6).fit(counts)
    tokens, lexicon = os.path.join(root, "wp.tokens"), os.path.join(root, "wp.lexicon")
    pieces = wp.save_tokens(counts, tokens)
    wp.save_lexicon(counts.keys(), lexicon, n_best=2)
    # save_tokens lists the pieces of each word's best segmentation; the
    # second-best ones may hold others, which the targets need as tokens
    with open(lexicon) as f:
        spelled = {p for line in f for p in line.split("\t", 1)[1].split()}
    extra = sorted(spelled - set(pieces))
    if extra:
        with open(tokens, "a") as f:
            f.write("\n".join(extra) + "\n")
    prep_s = time.perf_counter() - t0
    if n != WP_UTTS:
        fail(f"wordpiece: prepare_librispeech_split listed {n} of {WP_UTTS} utterances")
    flags = [a for a in soak_flags if not a.split("=")[0] in (
        "--train", "--valid", "--tokens", "--lexicon", "--rundir", "--runname", "--iter",
        "--reportiters", "--batchsize")]
    flags += [f"--train={lst}", f"--tokens={tokens}", f"--lexicon={lexicon}",
              f"--rundir={root}", "--runname=wp", f"--iter={WP_UPDATES}", "--reportiters=0",
              "--batchsize=16", "--usewordpiece=true", "--wordseparator=_", "--valid="]
    per_update = expected_launches(FLAGSHIP, 1, 0)
    with _train_steps() as rec:
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            tr = train_main(["train"] + flags)
        train_s = time.perf_counter() - t1
    launches, calls = rec.held("wordpiece training", {"train_step": per_update})
    n_classes, n_params = tr.n_classes, sum(p.numel() for p in tr.model.parameters())
    if calls.get("train_step") != WP_UPDATES or tr.updates != WP_UPDATES:
        fail(f"wordpiece: {calls} updates through cli.train, expected {WP_UPDATES}")
    del tr
    torch.cuda.empty_cache()
    am = os.path.join(root, "wp", "model_last.bin")
    kernels.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        res = test_main([f"--am={am}", f"--test={lst}", "--batchsize=4"])
    torch.cuda.synchronize()
    card_launches("wordpiece cli.test", expected_launches(FLAGSHIP, 0, WP_UTTS // 4))
    out = dict(utterances=n, words=len(counts), pieces=len(pieces), pieces_2best=len(extra),
               classes=n_classes,
               n_params=n_params, prep_s=prep_s, train_s=train_s, updates=WP_UPDATES,
               launches_per_update=per_update, losses=[c["loss"] for c in rec.calls],
               test=dict(WER=res["WER"], TER=res["TER"]), nvidia_smi=smi_line)
    if not all(math.isfinite(v) for v in (res["WER"], res["TER"], *out["losses"])):
        fail(f"wordpiece: {json.dumps(out)}")
    log(f"[wordpiece] {json.dumps(out)}")
    return out


def cpc_rank_flags(root, corpus):
    """The CPC jobs' flags and CPC flags (``CPC_DP_BATCH`` rows a rank, phase
    20's utterances); the one-process reference takes the global batch."""
    lst, _ = shortest(corpus["train"], os.path.join(root, "cpc_train.lst"), CPC_UTTS)
    nodrop = _cut_arch(CPC_ARCHS[1], os.path.join(root, "cpc_context_nodrop.arch"))
    flags = dict(flagsfile=CPC_CFG, arch=",".join([CPC_ARCHS[0], nodrop, CPC_ARCHS[2]]),
                 train=lst, train2=lst, tokens=corpus["tokens"], lexicon=corpus["lexicon"],
                 rundir=os.path.join(root, "cpc_runs"), runname="cpc", nthread=2, seed=0,
                 batchsize=CPC_DP_BATCH, optimepsilon=1e-4, iter=2)
    return flags, dict(unsupdates=1, supdates=1)


def cpc_rank_jobs(root, corpus):
    """CPC's jobs for two gloo ranks (phase 12's spawn in the full run): one
    unsupervised and one supervised update, then ``continue`` for 1; rank 0
    dumps the weights after each."""
    flags, cpc = cpc_rank_flags(root, corpus)
    return [dict(name="cpc", cpc=cpc, flags=flags, mode="train",
                 dump=os.path.join(root, "cpc_2.pt")),
            dict(name="cpc_continue", cpc=cpc, flags=dict(flags, iter=3), mode="continue",
                 dump=os.path.join(root, "cpc_3.pt"))]


def _cpc_dp_job(job, rank):
    """One CPC job on a rank: each update's phase, loss, launches and drained
    wall end, the gradient reduction's time, the weights' digest."""
    import hashlib

    import torch

    import wav2letter_tpu_torch.runtime.train_cpc as cpc_module
    from wav2letter_tpu_torch.config import Config

    reduce, reduce_ms = cpc_module.all_reduce_grads, []

    def timed_reduce(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        reduce(*a)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t) * 1e3)

    cfg = Config.from_sources(argv=_argv(job["flags"]))
    cpc_module.all_reduce_grads = timed_reduce
    try:
        tr = cpc_module.CPCTrainer(cfg, cpc_flags=job["cpc"], mode=job["mode"],
                                   device="cuda:0")
        with _Calls((cpc_module.CPCTrainer, "unsup_step"),
                    (cpc_module.CPCTrainer, "sup_step")) as rec:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.run()
    finally:
        cpc_module.all_reduce_grads = reduce
    state = {k: v.detach().cpu() for k, v in tr.net.state_dict().items()}
    h = hashlib.sha256()
    for k, v in state.items():
        h.update(k.encode())
        h.update(v.numpy().tobytes())
    if rank == 0:
        torch.save(state, job["dump"])
    ends = [t0] + [c["end"] for c in rec.calls]
    res = dict(updates=tr.updates, phases=[c["name"] for c in rec.calls],
               losses=[c["loss"] for c in rec.calls],
               launches=[c["launches"] for c in rec.calls],
               update_ms=[(b - a) * 1e3 for a, b in zip(ends, ends[1:])], reduce_ms=reduce_ms,
               digest=h.hexdigest(), n_params=sum(v.numel() for v in tr.net.parameters()))
    del tr
    torch.cuda.empty_cache()
    return res


def cpc_ranks_held(root, corpus, ranks, smi_line):
    """Phase 21 (d): the ranks' CPC jobs (``cpc_rank_jobs``) against one
    process at the global batch on the card: each update's launches
    (``CPC_SPEC``), the replicas equal in bits, the losses and the weights
    after 2 updates and after ``continue`` for 1 (against 3 straight
    updates) within ``CPC_DP_TOL``."""
    import torch

    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.runtime.train_cpc import CPCTrainer

    flags, cpc = cpc_rank_flags(root, corpus)
    per_update = expected_launches(CPC_SPEC, 1, 0)
    runs = [r["runs"] for r in ranks]
    for name, phases in (("cpc", ["unsup_step", "sup_step"]), ("cpc_continue", ["unsup_step"])):
        for r in runs:
            if r[name]["phases"] != phases or any(l != per_update for l in r[name]["launches"]):
                fail(f"cpc on {CPC_DP_RANKS} ranks, {name}: phases {r[name]['phases']}, "
                     f"launches {r[name]['launches']} (expected {per_update} an update)")
        if runs[0][name]["digest"] != runs[1][name]["digest"] or \
                runs[0][name]["losses"] != runs[1][name]["losses"]:
            fail(f"cpc on {CPC_DP_RANKS} ranks, {name}: the replicas or their losses differ")
    # one process at the global batch, 3 straight updates
    cfg = Config.from_sources(argv=_argv(dict(
        flags, rundir="", runname="", iter=3, batchsize=CPC_DP_BATCH * CPC_DP_RANKS)))
    tr = CPCTrainer(cfg, cpc_flags=cpc, device="cuda")
    p0 = {k: v.detach().cpu().clone() for k, v in tr.net.state_dict().items()}
    snaps, losses = [], []
    for name in ("unsup_step", "sup_step"):
        step = getattr(tr, name)

        def wrapped(*a, _step=step, **kw):
            res = _step(*a, **kw)
            losses.append(res[0])
            snaps.append({k: v.detach().cpu().clone() for k, v in tr.net.state_dict().items()})
            return res

        setattr(tr, name, wrapped)
    tr.run()
    del tr
    torch.cuda.empty_cache()
    got_losses = runs[0]["cpc"]["losses"] + runs[0]["cpc_continue"]["losses"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got_losses, losses))
    held = dict(losses=got_losses, one_process=losses, loss_rel_err=loss_err)
    for tag, dump, snap in (("after_2", "cpc_2.pt", snaps[1]), ("after_continue", "cpc_3.pt",
                                                                  snaps[2])):
        got = torch.load(os.path.join(root, dump))
        moved = math.sqrt(sum((snap[k] - p0[k]).double().pow(2).sum().item() for k in p0))
        diff = {k: (got[k] - snap[k]).double().norm().item() for k in p0}
        held[tag] = dict(param_rel_err=math.sqrt(sum(v * v for v in diff.values())) / moved,
                         moved=moved, worst=sorted(diff, key=diff.get)[-3:][::-1])
    r0 = runs[0]["cpc"]
    steady = r0["update_ms"][1:]
    held.update(n_params=r0["n_params"], update_ms=r0["update_ms"], reduce_ms=r0["reduce_ms"],
                reduce_share=sum(r0["reduce_ms"][1:]) / sum(steady), tol=list(CPC_DP_TOL),
                launches_per_update=per_update, nvidia_smi=smi_line)
    held["ok"] = bool(len(got_losses) == len(losses) == 3 and loss_err <= CPC_DP_TOL[0]
                      and held["after_2"]["param_rel_err"] <= CPC_DP_TOL[1]
                      and held["after_continue"]["param_rel_err"] <= CPC_DP_TOL[1])
    log(f"[cpc ranks] {json.dumps(held)}")
    log(f"[cpc ranks] gloo x{CPC_DP_RANKS} on one card, B = {CPC_DP_BATCH} a rank: update "
        f"{json.dumps(r0['update_ms'])} ms, reduction {json.dumps(r0['reduce_ms'])} ms "
        f"(share {held['reduce_share']:.3f}) | {smi_line}")
    if not held["ok"]:
        fail(f"cpc on {CPC_DP_RANKS} ranks differs from one process: {json.dumps(held)}")
    return held


def tools_path(tmp, corpus, inputs, smi_line, seed):
    """Phase 21: (a) the flashlight reader, (b) the production-scale decode,
    (c) data_prep and wordpiece into ``cli.train``, (d) CPC on two ranks.
    ``inputs`` (the full run) names phase 4's list and checkpoints, phase 10's
    LM and fp32 decode, phase 13's trained flagship and the directory of phase
    12's ranks; without them this makes phase 4's data and checkpoints, the
    3-gram, a seeded flagship on phase 13's tokens, and spawns the CPC ranks."""
    import torch

    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.data import read_list_file
    from wav2letter_tpu_torch.runtime.train import Trainer
    from wav2letter_tpu_torch.tools.ngram_lm import train_ngram_lm
    from wav2letter_tpu_torch.tools.soak import Soak

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "tools")
    os.makedirs(root, exist_ok=True)
    s = Soak(os.path.join(root, "seeded"), corpus=os.path.dirname(corpus["train"]),
             corpus_kw=SOAK_CORPUS, sizes=SOAK_SIZES, device="cuda")
    soak_flags = s._train_flags("flagship", 16, 0.2, 0, 0)
    laps = {}
    if inputs:
        lst, paths = inputs["lst"], inputs["paths"]
        tokens, lexicon = inputs["tokens"], inputs["lexicon"]
        arpa, soak_am, ranks_dir = inputs["lm"], inputs["soak_am"], inputs["ranks"]
        hyps10 = read_hyps(inputs["decode"], lst)
        ranks = []
        for r in range(CPC_DP_RANKS):
            with open(os.path.join(ranks_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    else:  # phases 4 and 13 in the part phase 21 reads
        lst, tokens, lexicon, _ = synth_dataset(os.path.join(root, "data"), seed)
        paths, _ = save_model(FLAGSHIP, root, seed, tokens, lexicon)
        text = os.path.join(root, "corpus.txt")
        with open(lst) as f, open(text, "w") as out:
            out.writelines(" ".join(line.split()[3:]) + "\n" for line in f)
        arpa = os.path.join(root, "lm.arpa")
        train_ngram_lm(text, arpa, order=3)
        tr = Trainer(Config.from_sources(argv=soak_flags + ["--seed=0", "--iter=0"]),
                     device="cuda")
        tr.save()
        soak_am = os.path.join(tr.rundir, "model_last.bin")
        del tr
        hyps10, ranks_dir = None, os.path.join(root, "ranks")
        os.makedirs(ranks_dir, exist_ok=True)
        ranks = _run_ranks(CPC_DP_RANKS, cpc_rank_jobs(ranks_dir, corpus), ranks_dir)
        laps["inputs"] = time.perf_counter() - t_phase
    secs = sum(u.duration_ms for u in read_list_file(lst)) / 1e3
    n_batches = batch_shapes(lst, tokens, lexicon)[0]
    out = {}
    out["flashlight"] = flashlight_tools(os.path.join(root, "flashlight"), paths, lst, secs,
                                         arpa, hyps10, n_batches, smi_line)
    laps["flashlight"] = time.perf_counter() - t_phase
    out["prod_scale"] = prod_scale_tools(os.path.join(root, "prod_scale"), corpus, soak_am,
                                         smi_line)
    laps["prod_scale"] = time.perf_counter() - t_phase
    out["wordpiece"] = wordpiece_tools(os.path.join(root, "wordpiece"), corpus, soak_flags,
                                       smi_line)
    laps["wordpiece"] = time.perf_counter() - t_phase
    out["cpc_ranks"] = cpc_ranks_held(ranks_dir, corpus, ranks, smi_line)
    laps["cpc_ranks"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    out.update(laps_s=laps, phase_s=time.perf_counter() - t_phase)
    log(f"[tools] phase 21 in {out['phase_s']:.1f} s (laps {json.dumps(laps)}) | {smi_line}")
    return out


def seeded_ams(tmp, s):
    """``--only lm``: the three AMs of phase 18 at their seeded initial
    weights (the ``Trainer``'s own) on the corpus of the soak ``s``, saved as
    their phases' runs would be."""
    from wav2letter_tpu_torch.config import Config
    from wav2letter_tpu_torch.runtime.train import Trainer

    root, corpus = os.path.join(tmp, "seeded"), s.paths
    train_lst, _ = shortest(corpus["train"], os.path.join(tmp, "seeded.lst"), 16)
    recipe = lambda name, *rest: [  # noqa: E731
        f"--flagsfile={os.path.join(REPO, 'recipes', name, 'train.cfg')}",
        f"--arch={os.path.join(REPO, 'recipes', name, 'network.arch')}",
        f"--train={train_lst}", f"--tokens={corpus['tokens']}",
        f"--lexicon={corpus['lexicon']}", f"--rundir={root}", f"--runname={name}", *rest]
    runs = {"flagship": s._train_flags("flagship", 16, 0.2, 0, 0),
            "conv_glu": recipe("conv_glu"),
            "seq2seq_tds": recipe("seq2seq_tds", "--encoderdim=512",
                                  *[f"--{k}={v}" for k, v in S2S_LETTERS.items()])}
    out = {}
    for name, flags in runs.items():
        tr = Trainer(Config.from_sources(argv=flags + ["--seed=0", "--iter=0"]), device="cuda")
        tr.save()
        out[name] = os.path.join(tr.rundir, "model_last.bin")
        del tr
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="directory for the detailed JSON")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="", choices=["", "s2s", "lm", "hooks", "semi", "tools"],
                    help="s2s: phases 1, 2, 16 and 17 alone, on phase 13's corpus and LM "
                         "made without its training; lm: phases 1, 2 and 18 alone, on "
                         "phase 13's corpus, with the AMs at their seeded weights; hooks: "
                         "phases 1, 2 and 19 alone, on phase 13's corpus; semi: phases 1, "
                         "2 and 20 alone, on phase 13's corpus and LM; tools: phases 1, 2, "
                         "the data and checkpoints of 4, the corpus of 13 and 21 alone; "
                         "each prints no result line")
    ap.add_argument("--corpus", default="",
                    help="with --only: phase 13's corpus directory, where it is made "
                         "already")
    ap.add_argument("--ams", default="",
                    help="with --only s2s: a JSON object of the flagship's and conv_glu's "
                         "checkpoints; phase 18 follows phases 16 and 17 with them and "
                         "phase 16's seq2seq_tds")
    ap.add_argument("--inputs", default="",
                    help="with --only tools: a JSON object of the full run's files that "
                         "phase 21 reads (phase 4's list, vocabulary and checkpoints, "
                         "phase 10's LM and decode, phase 13's flagship, phase 12's ranks)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        sys.exit(2)
    if not os.path.isdir(os.path.join(REPO, "wav2letter_tpu_torch")) \
            or not all(os.path.exists(a) for a in (ARCH, TR_ARCH, CFR_ARCH, GLU_ARCH, RES_ARCH,
                                                   *(os.path.join(REPO, "recipes", n,
                                                                  "network.arch")
                                                     for n in S2S_RECIPES))):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, REPO)
    from wav2letter_tpu_torch import kernels
    from wav2letter_tpu_torch.models import build_arch_module

    t_start = time.perf_counter()
    kernels.disable_tf32()
    # 1. device
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    smi_line = smi[0].strip() if smi else "nvidia-smi: no output"
    log(f"[device] {kind} x{count} | {smi_line} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    lib_path = kernels._build.build()
    kernels.library()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    build_log = (kernels._build.BUILD_DIR / "build.log")
    ptxas = []
    if build_log.exists():
        ptxas = [line.strip() for line in build_log.read_text().splitlines()
                 if re.search(r"Compiling entry|Used \d+ registers|spill", line)]
        for line in ptxas:
            log(f"[ptxas] {line}")

    if args.only:
        with tempfile.TemporaryDirectory(prefix="w2l_chip_smoke_") as tmp:
            from wav2letter_tpu_torch.tools.soak import Soak

            s = Soak(os.path.join(tmp, "soak"),
                     corpus=args.corpus or os.path.join(tmp, "soak_corpus"),
                     corpus_kw=SOAK_CORPUS, sizes=SOAK_SIZES, device="cuda")
            if not (args.corpus and os.path.exists(os.path.join(args.corpus, "meta.json"))):
                s.phase_corpus()
            out, ams = {}, None
            if args.only == "hooks":
                log(f"[time] phase 19 starts at {time.perf_counter() - t_start:.1f} s")
                out["hooks"] = hooks_path(tmp, s.paths, smi_line, args.seed)
            elif args.only == "s2s":
                if args.ams:  # the full run: 19 first (its ranks' jobs ran in phase 12)
                    log(f"[time] phase 19 starts at {time.perf_counter() - t_start:.1f} s")
                    out["hooks"] = hooks_path(tmp, s.paths, smi_line, args.seed,
                                              parallel=False)
                s.phase_lm()
                corpus = dict(s.paths, lm=os.path.join(s.root, "lm3.arpa"))
                out.update({name: s2s_path(name, tmp, corpus, smi_line)
                            for name in S2S_RECIPES})
                ams = dict(json.loads(args.ams), seq2seq_tds=out["seq2seq_tds"]["am"]) \
                    if args.ams else None
            elif args.only == "lm":
                ams = seeded_ams(tmp, s)
            elif args.only == "tools":
                log(f"[time] phase 21 starts at {time.perf_counter() - t_start:.1f} s")
                out["tools"] = tools_path(tmp, s.paths, json.loads(args.inputs)
                                          if args.inputs else None, smi_line, args.seed)
            elif args.only == "semi":
                s.phase_lm()
                log(f"[time] phase 20 starts at {time.perf_counter() - t_start:.1f} s")
                out["semi"] = semi_path(tmp, dict(s.paths, lm=os.path.join(s.root, "lm3.arpa")),
                                        smi_line)
            if ams:
                log(f"[time] phase 18 starts at {time.perf_counter() - t_start:.1f} s")
                out["lm"] = lm_path(tmp, s.paths, ams, smi_line)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"chip_smoke_{args.only}.json"), "w") as f:
                json.dump(dict(device=kind, nvidia_smi=smi_line, **out,
                               seconds=time.perf_counter() - t_start), f, indent=1)
        log(f"[done] --only {args.only} in {time.perf_counter() - t_start:.1f} s")
        return

    with tempfile.TemporaryDirectory(prefix="w2l_chip_smoke_") as tmp:
        # data and flagship checkpoints for the main path
        lst, tokens, lexicon, secs = synth_dataset(os.path.join(tmp, "data"), args.seed)
        paths, n_params = save_model(FLAGSHIP, tmp, args.seed, tokens, lexicon)
        n_batches, T, S = batch_shapes(lst, tokens, lexicon)
        with torch.device("meta"):
            model = build_arch_module(ARCH, N_FEAT, N_TOKENS + 1)
        convs, lns = path_calls(model, BATCH, T)
        log(f"[shapes] largest batch B={BATCH} S={S} T={T}; {len(convs)} K2 and "
            f"{len(lns)} K3 calls per forward")

        train_lst, _, _, train_secs = synth_dataset(
            os.path.join(tmp, "data"), args.seed + 1, TRAIN_UTTS, "train", (tokens, lexicon))
        fl_batch = FLAGSHIP["train"]["batchsize"]
        _, T_train, S_train = batch_shapes(train_lst, tokens, lexicon, fl_batch)
        tconvs, tlns = path_calls(model, fl_batch, T_train)
        log(f"[shapes] largest training batch B={fl_batch} S={S_train} T={T_train}; "
            f"{train_secs:.1f} s of audio in {TRAIN_UTTS} utterances")
        # the transformer: three stride-2 pools ahead of 12 layers of H=4, Dh=192
        tr_batch = TRANSFORMER["train"]["batchsize"]
        _, T_tr_train, _ = batch_shapes(train_lst, tokens, lexicon, tr_batch)
        Ta, Ta_train = pooled_frames(T), pooled_frames(T_tr_train)
        attn_shapes = [("serve", BATCH, Ta, 4, 192, True, 12),
                       ("train", tr_batch, Ta_train, 4, 192, True, 12),
                       ("unmasked", BATCH, 188, 4, 192, False, 0),
                       ("gate_edge", 2, 460, 4, 192, True, 0),
                       ("conformer", 8, 240, 4, 128, True, 0),
                       ("ragged17", 2, 17, 4, 192, True, 0),
                       ("ragged65", 2, 65, 4, 192, True, 0)]
        tr_lns, tr_tlns = [(BATCH * Ta, 768)] * 24, [(tr_batch * Ta_train, 768)] * 24
        log(f"[shapes] transformer: attention over T={Ta} (serving, B={BATCH}) and "
            f"T={Ta_train} (training, B={tr_batch}); 12 K4 and 24 K3 calls per forward")

        log(f"[time] phase 3 starts at {time.perf_counter() - t_start:.1f} s")
        # 3. kernels against their plain versions
        details = []
        rows = {"mfsc": check_mfsc(BATCH, S, details)}
        check_mfsc(fl_batch, S_train, details, "train")  # the update's K1, B = 16
        check_mfsc_edges(details)
        def stamp(what):
            log(f"[time] phase 3 {what} done at {time.perf_counter() - t_start:.1f} s")

        for dt in ("float32", "bfloat16"):
            rows[("time_conv", dt)] = check_time_conv(convs, dt, details, CONV_EDGES)
            stamp(f"K2 {dt}")
            rows[("residual_ln", dt)] = check_residual_ln(lns, dt, details)
            check_residual_ln_edges(dt, details)
            stamp(f"K3 {dt}")
            back = check_time_conv_backward(tconvs, dt, details, CONV_EDGES)
            rows[("time_conv_dgrad", dt)] = back["time_conv_dgrad"]
            rows[("time_conv_wgrad", dt)] = back["time_conv_wgrad"]
            stamp(f"dgrad, K2b {dt}")
            rows[("residual_ln_bwd", dt)] = check_residual_ln_bwd(tlns, dt, details)
            rows[("residual_ln@transformer", dt)] = check_residual_ln(tr_lns, dt, details)
            rows[("residual_ln_bwd@transformer", dt)] = check_residual_ln_bwd(
                tr_tlns, dt, details)
            stamp(f"K3b {dt}")
            att = check_attention(attn_shapes, dt, details)
            stamp(f"K4, K4b {dt}")
            check_attention_bwd(k4b_edges(dt), dt, details)
            stamp(f"K4b edges {dt}")
            rows[("mhsa", dt)] = [r for r in att["mhsa"] if r["tag"] == "serve"]
            rows[("mhsa_bwd", dt)] = [r for r in att["mhsa_bwd"] if r["tag"] == "train"]
            torch.cuda.empty_cache()
        for r in details:
            r["bound_share"] = r["bound_ms"] / r["ms"]
            log(f"[kernel] {json.dumps(r)}")
        # each kernel over one pass (its rows weighted by their calls), per type
        sums = []
        for key, krows in rows.items():
            name, dt = ("mfsc", "float32") if key == "mfsc" else key
            sums.append(dict(name=name, dtype=dt, calls=sum(r["calls"] for r in krows),
                             per=("update" if "bwd" in name or "grad" in name else "forward"),
                             **per_forward(krows)))
            log(f"[kernel sum] {json.dumps(sums[-1])}")
        bad = [r for r in details if not r["ok"]]
        if bad:
            fail(f"{len(bad)} kernel checks disagree with the plain versions: "
                 f"{json.dumps(bad[0])}")

        log(f"[time] phase 4 starts at {time.perf_counter() - t_start:.1f} s")
        # 4. the main path: serving
        served, ev, ds_main = main_path(FLAGSHIP, paths, lst, secs, os.path.join(tmp, "em"),
                                        n_batches)

        log(f"[time] phase 5 starts at {time.perf_counter() - t_start:.1f} s")
        # 5. where one bf16 forward's device time goes
        prof = profile_forward(ev, ds_main)
        log(f"[profile] {json.dumps(prof)}")
        del ev, ds_main
        torch.cuda.empty_cache()

        log(f"[time] phase 6 starts at {time.perf_counter() - t_start:.1f} s")
        # 6. the main path: training
        trained = training_path(FLAGSHIP, tmp, train_lst, lst, tokens, lexicon, n_batches)

        log(f"[time] phase 7 starts at {time.perf_counter() - t_start:.1f} s")
        # 7. the transformer: serving, one profiled forward, training
        tr_paths, tr_params = save_model(TRANSFORMER, tmp, args.seed, tokens, lexicon)
        log(f"[transformer] {tr_params} parameters")
        tr_served, ev, ds_main = main_path(TRANSFORMER, tr_paths, lst, secs,
                                           os.path.join(tmp, "em"), n_batches)
        tr_prof = profile_forward(ev, ds_main)
        log(f"[profile transformer] {json.dumps(tr_prof)}")
        del ev, ds_main
        torch.cuda.empty_cache()
        tr_trained = training_path(TRANSFORMER, tmp, train_lst, lst, tokens, lexicon,
                                   n_batches)

        log(f"[time] phase 8 starts at {time.perf_counter() - t_start:.1f} s")
        # 8. the conformer
        conformer = conformer_path(tmp, tokens, lexicon, args.seed)

        log(f"[time] phase 9 starts at {time.perf_counter() - t_start:.1f} s")
        # 9. the long-context transformer
        long_context = long_context_path(tmp, tokens, lexicon, args.seed)

        log(f"[time] phase 10 starts at {time.perf_counter() - t_start:.1f} s")
        # 10. the lexicon beam decode of the flagship
        decoded = decode_path(paths, lst, secs, tmp, n_batches, smi_line)

        log(f"[time] phase 11 starts at {time.perf_counter() - t_start:.1f} s")
        # 11. chunked streaming inference of the flagship
        streamed = stream_path(paths, lst, secs, tmp, smi_line)

        log(f"[time] phase 12 starts at {time.perf_counter() - t_start:.1f} s")
        # 12. data and tensor parallelism through torch.distributed
        torch.cuda.empty_cache()
        parallel = data_parallel_path(tmp, train_lst, lst, tokens, lexicon, smi_line,
                                      args.seed)

        log(f"[time] phase 13 starts at {time.perf_counter() - t_start:.1f} s")
        # 13. the soak in small: corpus, LM, training killed and continued, the chain
        torch.cuda.empty_cache()
        soaked = soak_path(tmp, smi_line)

        log(f"[time] phase 14 starts at {time.perf_counter() - t_start:.1f} s")
        # 14. conv_glu with ASG: train, continue, test, decode, align
        torch.cuda.empty_cache()
        asg = asg_path(tmp, soaked["corpus"], smi_line)

        log(f"[time] phase 15 starts at {time.perf_counter() - t_start:.1f} s")
        # 15. resnet_ctc with CTC: train, test, align
        torch.cuda.empty_cache()
        resnet = resnet_path(tmp, soaked["corpus"], smi_line)

        log(f"[time] phases 19, 16, 17, 18 start at {time.perf_counter() - t_start:.1f} s")
        # 19. the hooks (the mls plugin; the flagship with --remat, host
        # features, sfx; its ranks' jobs ran in phase 12);
        # 16, 17. the attention seq2seq recipes: train, continue, test, decode;
        # 18. the LM slice, decoding with phase 13's flagship, phase 14's
        # conv_glu and phase 16's seq2seq_tds. In a process of their own:
        # after phases 3-15 this process's profiler came back without a device
        # event at phase 16's second K2 row, ten readings in a row (seen on the
        # H100), where a fresh one reads them. The child makes phase 13's
        # corpus and LM again from the same seed.
        torch.cuda.empty_cache()
        s2s_dir = os.path.join(tmp, "s2s")
        ams = {"flagship": os.path.join(tmp, "soak", "b128", "model_last.bin"),
               "conv_glu": os.path.join(tmp, "asg", "runs", "conv_glu_bfloat16",
                                        "model_last.bin")}
        child = subprocess.run([sys.executable, os.path.abspath(__file__), "--only", "s2s",
                                "--out", s2s_dir, "--seed", str(args.seed),
                                "--ams", json.dumps(ams)], timeout=900)
        if child.returncode != 0:
            fail(f"phases 19, 16, 17 and 18 (a child process) exited {child.returncode}")
        with open(os.path.join(s2s_dir, "chip_smoke_s2s.json")) as f:
            s2s = json.load(f)
        hooks = dict(s2s.pop("hooks"), parallel=parallel["hooks"])
        s2s = {k: v for k, v in s2s.items() if k in S2S_RECIPES or k == "lm"}
        log(f"[time] phases 19, 16, 17, 18 end at {time.perf_counter() - t_start:.1f} s")

        # 20. the semi- and self-supervised trainers, in a process of their own
        # for the same reason; it makes phase 13's corpus and LM again
        semi_dir = os.path.join(tmp, "semi_out")
        child = subprocess.run([sys.executable, os.path.abspath(__file__), "--only", "semi",
                                "--out", semi_dir, "--seed", str(args.seed)], timeout=600)
        if child.returncode != 0:
            fail(f"phase 20 (a child process) exited {child.returncode}")
        with open(os.path.join(semi_dir, "chip_smoke_semi.json")) as f:
            semi = json.load(f)["semi"]
        log(f"[time] phase 20 ends at {time.perf_counter() - t_start:.1f} s")

        # 21. the tools, the flashlight reader and CPC on two ranks (run by
        # phase 12's ranks), in a process of their own on this run's files
        tools_dir = os.path.join(tmp, "tools_out")
        inputs = dict(lst=lst, tokens=tokens, lexicon=lexicon, paths=paths,
                      lm=os.path.join(tmp, "decode", "lm.arpa"),
                      decode=os.path.join(tmp, "decode", "float32", "topk"),
                      soak_am=os.path.join(tmp, "soak", "b128", "model_last.bin"),
                      ranks=os.path.join(tmp, "dp"))
        child = subprocess.run([sys.executable, os.path.abspath(__file__), "--only", "tools",
                                "--out", tools_dir, "--seed", str(args.seed), "--corpus",
                                os.path.join(tmp, "soak_corpus"), "--inputs",
                                json.dumps(inputs)], timeout=600)
        if child.returncode != 0:
            fail(f"phase 21 (a child process) exited {child.returncode}")
        with open(os.path.join(tools_dir, "chip_smoke_tools.json")) as f:
            tools = json.load(f)["tools"]
        log(f"[time] phase 21 ends at {time.perf_counter() - t_start:.1f} s")

    kernels_line = []
    fwd, upd = "forward of the largest serving batch", "update on the largest training batch"
    for name, per, model_name in (
            ("mfsc", fwd, "flagship"), ("time_conv", fwd, "flagship"),
            ("time_conv_wgrad", upd, "flagship"), ("residual_ln", fwd, "flagship"),
            ("residual_ln_bwd", upd, "flagship"), ("mhsa", fwd, "transformer"),
            ("mhsa_bwd", upd, "transformer")):
        dt = "float32" if name == "mfsc" else "bfloat16"
        agg = per_forward(rows["mfsc" if name == "mfsc" else (name, dt)])
        replaces, source = TPU_KERNELS[name]
        backward = per == upd
        path_served, path_trained = ((served, trained) if model_name == "flagship"
                                     else (tr_served, tr_trained))
        train_launches = path_trained["bfloat16"]["launches_per_update"]
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces, model=model_name,
            launches=(train_launches[name] if backward
                      else path_served["bfloat16"]["launches"][name]),
            launches_per_update=train_launches[name], dtype=dt,
            max_abs_err=agg["max_abs_err"], ms=agg["ms"],
            plain_ms=agg["plain_ms"],
            bound_ms=agg["bound_ms"], bound_by=agg["bound_by"],
            library_ms=agg["library_ms"], per=per)
        if name in ("mfsc", "residual_ln"):  # which of the kernel's two routes ran
            krows = rows["mfsc" if name == "mfsc" else (name, dt)]
            entry["kernel_route"] = sorted({r["route"] for r in krows})
        if name == "residual_ln":  # F.layer_norm of a precomputed sum, the old yardstick
            entry["layer_norm_ms"] = sum(r["layer_norm_ms"] * r["calls"] for r in krows)
        if name == "time_conv":  # the same kernel as dgrad, per update
            dg = per_forward(rows[("time_conv_dgrad", dt)])
            entry["dgrad"] = {k: dg[k] for k in ("ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms", "max_abs_err")}
        if name in ("time_conv", "time_conv_wgrad"):  # the fp32 route (3xTF32)
            parts = ([("forward", name), ("dgrad", "time_conv_dgrad")] if name == "time_conv"
                     else [("wgrad", name)])
            entry["float32"] = {}
            for part, key in parts:
                krows = rows[(key, "float32")]
                agg = per_forward(krows)
                entry["float32"][part] = dict(
                    routes=sorted({r["route"] for r in krows}),
                    **{k: agg[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms", "max_abs_err")})
        if name == "mhsa_bwd":  # K4b's time by launch
            krows = rows[(name, dt)]
            entry["split_ms"] = {k: sum(r["split_ms"].get(k, 0.0) * r["calls"] for r in krows)
                                 for k in {k for r in krows for k in r["split_ms"]}}
        if name in ("mfsc", "time_conv", "residual_ln"):  # phase 11, per launch
            srows = [r for r in streamed["kernels"] if r["name"] == name]
            entry["stream"] = dict(
                launches=streamed["launches"][{"mfsc": "k1", "time_conv": "k2",
                                               "residual_ln": "k3"}[name]],
                dtype="float32", shapes=[r["shape"] for r in srows],
                **{k: [r[k] for r in srows]
                   for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
                max_abs_err=max(r["max_abs_err"] for r in srows))
            if name == "time_conv":
                entry["stream"]["chunk_ms"] = streamed["k2_chunk"]["ms"]
        kernels_line.append(entry)
    # phase 19: the mls plugin's K3, K3b, K4 and K4b at its shapes, launches of
    # its bf16 training run
    mls = hooks["mls"]
    for name in ("residual_ln", "residual_ln_bwd", "mhsa", "mhsa_bwd"):
        agg = per_forward(mls["kernel_rows"][f"{name}@bfloat16"])
        replaces, source = TPU_KERNELS[name]
        kernels_line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, model="mls_plugin",
            launches=mls["runs"]["bfloat16"]["launches"][name],
            launches_per_update=expected_launches(MLS_SPEC, 1, 0)[name], dtype="bfloat16",
            max_abs_err=agg["max_abs_err"], ms=agg["ms"], plain_ms=agg["plain_ms"],
            bound_ms=agg["bound_ms"], bound_by=agg["bound_by"],
            library_ms=agg["library_ms"], per="update on the largest training batch"
            if name.endswith("_bwd") else "forward of the largest training batch"))
    # phase 20: CPC's K2 and K2b (the encoder's first conv on raw audio) and K3,
    # K3b (its context's rows of 768) at its largest batch, fp32, launches of
    # its 4 updates
    cpc = semi["cpc"]
    for name in ("time_conv", "time_conv_wgrad", "residual_ln", "residual_ln_bwd"):
        agg = per_forward(cpc["kernel_rows"][name])
        replaces, source = TPU_KERNELS[name]
        kernels_line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, model="cpc",
            launches=cpc["training"]["launches"][name],
            launches_per_update=expected_launches(CPC_SPEC, 1, 0)[name], dtype="float32",
            max_abs_err=agg["max_abs_err"], ms=agg["ms"], plain_ms=agg["plain_ms"],
            bound_ms=agg["bound_ms"], bound_by=agg["bound_by"],
            library_ms=agg["library_ms"], per="update on the largest training batch"
            if name in ("time_conv_wgrad", "residual_ln_bwd")
            else "forward of the largest training batch"))
    summary = dict(kernels=kernels_line)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(device=kind, nvidia_smi=smi_line, ptxas=ptxas, details=details,
                           sums=sums,
                           main=served,
                           profile=prof, training=trained, kernels=kernels_line,
                           n_params=n_params,
                           transformer=dict(n_params=tr_params, main=tr_served,
                                            profile=tr_prof, training=tr_trained),
                           conformer=conformer, long_context=long_context,
                           decode=decoded, streaming=streamed, data_parallel=parallel,
                           soak=soaked, conv_glu=asg, resnet_ctc=resnet, **s2s,
                           hooks=hooks, semi=semi, tools=tools,
                           seconds=time.perf_counter() - t_start), f, indent=1)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(summary))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
