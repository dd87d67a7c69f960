#!/usr/bin/env python3
"""Card run of the PyTorch/CUDA port (``vit_ssl_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device   — needs a CUDA device; prints the card's name and power limit
2. build    — compiles every kernel library from ``csrc/``, one nvcc each,
              all at once; prints registers and spills, and fails on a
              spill or a serialised wgmma (ptxas C7514, C7515, C7520) in
              any Hopper (``*_sm90_kernel``) body
3. kernels  — kernel B1 against its plain PyTorch versions on the card:
              the inference forward, the training forward (output and
              softmax statistics) and the backward (dq, dk, dv), the bf16
              forward in its one-pass (N <= 256) and two-pass forms, the
              bf16 backward in its resident (N <= 256) and streamed forms,
              also at ViT-B/16's 224-px shape (1024, 197, 12 x 64), bf16 and
              fp32, SimMIM's (128, 144, 6 x 64) and the patch-dropout
              (1024, 99, 12 x 64), bf16, and the visualizers' batch-1 inference
              shapes (1, 197, 12 x 64) and (1, 144, 6 x 64), bf16, and the
              orbax fixture step's (8, 5, 1 x 32) and (4, 8, 1 x 32, block
              2), fp32; each head kept
              to its columns and each image to its
              rows, two calls bit-equal; kernel B4
              (fused MLP): its three forwards (no mask; keep-mask; keep-mask
              and saved pre) and its backward (with and without the mask)
              at every token count of the main paths, and at d_model 768 /
              d_ff 3072 (T = 36928, ViT-B/16 at 384 px) and 1024 / 4096
              (T = 12608, ViT-L/16 at 224 px), bf16 (the wgmma/TMA products
              of ``csrc/mlp_gemm_sm90.cuh``) and fp32; kernel P2
              (dropout-masked second FFN product): its forward and backward
              at T = 37120 x (1536 -> 384), a ragged T, T = 1 and ViT-B's
              3072 -> 768 at T = 36928, bf16 (B4's wgmma/TMA product with h
              masked on its way in; a profile of each entry at each case
              must name its Hopper kernels and no other) and fp32
4. serving  — a DINO ViT-S/8 ``Server`` at batch 128 through its
              ``forward_batch`` entry point: launch counts, agreement with
              the plain attention path, padding rows inert
5. serving times — warm batch, kernel, plain and library times (CUDA
              events) of B1's inference forward at (128, 145), beside the
              mma.sync body's recorded time, and a ``torch.profiler``
              breakdown of five batches, which must show B1's Hopper body
6. fused serving — the same weights with ``model.use_fused_mlp=true``:
              B4 and B1 launch counts, agreement with the unfused server,
              warm batch
7. training — DINO ViT-S/8 ``train_step`` at full width and depth, batch
              128 (2 globals of 96 px, 4 packed locals of 48 px), views made
              on the card from uint8 images: launch counts per step,
              finite losses, moving state, agreement with the plain
              attention path from one cloned state
8. training times — warm step, kernel/plain/library times of B1 at the
              two training shapes (forward and backward, beside the mma.sync
              bodies' recorded times; SDPA's backward fed dO strided and
              contiguous, in turns) and the teacher's inference forward at
              (256, 145), and a ``torch.profiler`` breakdown of three
              steps, which must show B1's Hopper forward and both kernels of
              its Hopper backward, 36 launches each
9. fused training — the same step with ``model.use_fused_mlp=true``:
              B4 and B1 launch counts per step, agreement with the unfused
              step from one cloned state, warm step, a profile of three
              steps (and peak memory, as the unfused leg's), and B4's
              kernel/plain/unfused-chain times at each width, each entry's
              host microseconds a call through its wrapper, and a profile
              of each timed call that must name its Hopper kernels
9.1 scan — the DINO training step with ``model.scan_layers=true`` from
              phase 7's initial weights stacked (``flat_to_scanned``): loss,
              student, teacher, center and AdamW moments bit-equal to the
              unrolled step's; its ``state.pt`` through ``flat_to_unrolled``
              loads strictly into an unrolled state; both warm steps
9a. DINO trainer — the same main path through the port's own trainer:
              configs/dino.yaml composed by ``vit_ssl_tpu_torch.config``
              (checked against DINO_VIT_S8), the loaders of its seeded split
              over 1300 in-memory uint8 images, ``DINOTrainer.fit(2)``: 18
              train and 6 val steps, B1's launches exact in each, no plain
              attention, finite epoch metrics, best_model and last_model
              written with their metadata; a fresh trainer resumed from
              last_model (bit-equal to the file) trains epoch 3 to step 27;
              epoch wall seconds and images a second, the input-wait share,
              the in-loop step beside the bare warm step, each checkpoint's
              snapshot and background write, peak memory
9a.0 orbax resume — the JAX package's checkpoints read without orbax: every
              fixture of tests/torch_orbax_fixtures (written by the JAX
              trainers) read by the port's reader (``utils/orbax_tree.py``:
              OCDBT, zarr, the zstd decoder of ``csrc/zstd_decode.cpp`` built
              with the host compiler) to the sha256, shape and dtype of its
              digests.json, the decoder's MB/s on their frames, and a port
              DINO trainer at the fixture's width (its head narrowed alike)
              resumed from ``dino_step1`` trains one step, B1's launches
              exact at the fixture's shapes (ORBAX_FIXTURE_B1_CASES, held
              against plain attention in phase 3); then phase 9a's last_model
              (step 18) written as a JAX-layout orbax tree
              (``train_state_to_flax``, ``write_tree``) beside it, a fresh
              trainer from configs/dino.yaml resumed from that directory
              (bit-equal to last_model, start epoch 2) trains epoch 3 to step
              27, bit-equal to phase 9a's resumed run with its B1 launches;
              the tree's write and read seconds and MB/s, ``resume_from``'s
              ms and the epoch's wall seconds
9a.1 preempt — configs/dino.yaml with PREEMPT_OVERRIDES through the CLI's
              own flow (``train.__main__.fit_with_preemption``) over the
              same in-memory images: fault injection stops the run at epoch
              2 after 4 batches with exit 75 and a preempt_model that says
              so (its snapshot and write timed); the same call again
              auto-resumes, trains the other 5 batches and removes it, and
              its last_model equals phase 9a's straight fit(2) bit for bit
9a.2 data parallel — configs/dino.yaml with DP_OVERRIDES (parallel.fsdp)
              in an NCCL process group of one rank started here (a TCP
              store on a free port): the port's mesh published, the same
              in-memory images, ``fit(2)`` with the gradients reduced, the
              weight sums, center and statistics all-reduced and the
              parameters gathered for each step and freed after; its
              last_model against phase 9a's straight fit(2) (bit-equal, or
              within the trainer's bars), NCCL's device operations and
              B1's kernels counted in one profile window of 3 steps, the
              in-loop step and peak memory beside phase 9a's; the group
              destroyed at the end
9a.3 host multi-crop — DINO ViT-S/8 from a folder of 320 seeded 96 px
              PNGs (this script's encoder, row filters 0-4 in turn) with
              ``data.device_augment=false``: the port's PNG decoder bit-equal
              to the encoded arrays and ``native_batch`` to the per-sample
              path; configs/dino.yaml composed by the port (checked against
              DINO_VIT_S8) through the CLI's ``main`` for one epoch (2 train
              and 1 val steps, the views made on the host by the config's
              globals and locals pipelines), B1's launches exact, checkpoints
              written; one host-views step against plain attention from one
              cloned state; the PNGs served through ``Server.infer`` against
              ``forward_batch`` on the decoded arrays; host ms per view of
              each pipeline, decode ms per image, the epoch's img/s and
              input-wait share beside phase 9a's
9a.4 JPEG folder — ViT-B/16 224 from an ImageNet-layout folder of 533
              JPEGs (64 seeded pictures at ImageNet's common sizes, this
              script's baseline encoder at 4:2:0 and 4:4:4, hard-linked
              into 10 class folders): the port's JPEG decoder built with
              the host compiler and held to the cv2 and PIL digests of
              tests/torch_jpeg_fixtures; configs/vit_b_imagenet.yaml with
              the folder and batch 256 through the CLI's ``main`` for one
              epoch (2 train and 1 val steps, 8 loader threads), B1's
              launches exact, checkpoints written; one JPEG-batch step
              against plain attention from one cloned state; 64 JPEGs
              served through ``Server.infer`` against ``forward_batch`` on
              the decoded arrays; decode ms a picture on 1 and 8 threads,
              the epoch's img/s and input-wait share, the bare step alone
              and while 8 threads decode, or decode and resize
9b. finetune — configs/finetune.yaml composed by the port with
              FINETUNE_OVERRIDES (ViT-S/8 at 96 px, extended transfer, the
              backbone frozen until epoch 2), from phase 9a's DINO
              best_model: every backbone tensor matched
              (``check_loaded_model``), ``SupervisedTrainer.fit(2)`` over
              1300 in-memory labeled images with B1's launches exact in
              each step, the frozen tensors unchanged bit for bit through
              epoch 1 and moved after the unfreeze
9c. SimMIM trainer — configs/simmim.yaml (ViT-S/16 at 192 px, N = 144,
              mask ratio 0.5) composed by the port (checked against
              SIMMIM_VIT_S16), ``SimMIMTrainer.fit(2)`` over 400 in-memory
              uint8 images (3 train and 1 val step an epoch): B1's launches
              exact in each step (6 training forwards and 6 backwards a train
              step, 6 inference forwards a val step), no plain attention,
              finite PSNR and SSIM, best_model and last_model; a resumed
              epoch 3 bit-equal to a straight fit(3); warm step, img/s,
              device busy and idle share, peak memory, the in-loop step and
              the input-wait share; one step against the plain-attention
              step from one cloned state
9d. gradient accumulation — a SimMIM step at grad_accum 4 and a DINO
              ViT-S/8 step at grad_accum 2, each against grad_accum 1 from
              one cloned state (dropout 0; SimMIM at mask ratio 1), B1's
              launches exact; Bernoulli dropout's keep rate within 4 sigma
9e. SimMIM serving — the trained model as a ``.pth`` through
              ``Server.forward_batch`` at batch 128: 6 B1 inference launches
              a batch, padding rows inert, row cosine >= 0.999 to the
              plain-attention embedding, the warm batch; then B1's three
              entries at (128, 144, 6 x 64): kernel, plain, SDPA and bound
10. B3 kernels — kernel B3 (head-major fused attention) against its plain
              versions: inference forward, training forward and backward at
              ViT-B/16's (64, 12, 577, 64), at N = 1, N = 1024 and ragged N,
              bf16 and fp32; B1 on the same data (the same forward bodies:
              bit-equal); each head kept to its own rows (a neighbouring
              head of inf); two calls bit-equal
11. supervised serving — the supervised ViT-B/16 at 384 px (N = 577) from
              a written ``.pth``, batch 64, through ``Server.forward_batch``:
              12 B3 inference launches a batch and nothing else, agreement
              with the plain attention path, padding rows inert, warm batch,
              a profile
12. supervised training — its ``train_step`` at batch 64 from uint8
              images augmented on the card: 12 B3 training forwards and 12
              backwards a step, agreement with the plain attention path from
              one cloned state, warm step, peak memory, a profile;
              ``eval_step``'s 12 inference launches
12a. fused supervised serving and training — phases 11 and 12 with
              ``model.use_fused_mlp=true`` (kernel B4 at d_model 768): 12 B3
              and 12 B4 forwards a served batch and an ``eval_step``; 12 B3
              training forwards and backwards and 12 B4 training forwards
              and backwards a step; agreement with the unfused server and
              the unfused step from one cloned state (the same masks); then
              B3's times beside B1's on the same data, SDPA's and (the
              forwards) the mma.sync body's; profiles of 5 forward and 5
              backward calls
13. B2 kernels — kernel B2 (blockwise flash attention) against its plain
              versions: the forward (o and lse) and the dq and dk/dv
              kernels, with and without an lse cotangent, at ViT-B/16's
              (64, 12, 1025, 64), N = 1, a ragged N, N = 2048 and 4096, head
              dims 32 and 128, bf16 and fp32; in bf16 also P1 against its
              plain version, both forwards bit-equal on a second call, and
              each head kept to its own rows (a NaN planted in one head's
              K), forwards and backward (and, apart, in one head's dO)
              (run beside the other kernel checks, before any model)
14. supervised serving and training at 512 px (N = 1025) — phases 11 and
              12 at full width and depth with every block on B2: 12 B2
              forwards a served batch and an ``eval_step``, 12 forwards, 12
              dq and 12 dk/dv launches a training step, and a profile of
              three steps naming the Hopper backward's two kernels 36 times
              each and no mma.sync backward body
15. B2 times — kernel, plain, SDPA and bound at (64, 12, 1025, 64) bf16,
              beside the mma.sync backward's recorded times
15a. ring — ring attention's per-rank body
              (``parallel/ring_attention.py``) over RING_SP = 5 virtual
              ranks at (64, 12, 1025, 64) bf16, every hop through B2: 25
              forwards, 25 dq and 25 dk/dv launches counted; against B2 on
              the whole sequence and the plain version at the B2 bars; the
              ring's forward and backward time beside B2's whole-sequence
15b. tensor and expert parallel — the layers' per-rank bodies
              (``parallel/tensor_parallel.py``) over virtual ranks in this
              process, each against the unsharded layer from the same
              parameters, inputs and dropout draws (output row cosine >=
              0.999, every gradient's cosine >= 0.99, no plain version):
              DINO ViT-S/8's block unfused and fused at (256, 145) and
              packed (128, 148, block 37), and its head, at tp = 2 (B1 at
              3 x 64 heads, B4 at 384 -> 768); a ViT-B/16 block at 384 px
              (B3 at (64, 6, 577, 64)) and 512 px (B2 at (64, 6, 1025,
              64)) at tp = 2; a V-MoE ViT-B/16 MoE block at ep = 4; the
              launches counted at the local shapes, each way timed; then
              each of those kernels at its local shape: kernel, plain,
              SDPA and bound
15c. pipeline — the pipeline's per-stage bodies
              (``parallel/pipeline.py``) over virtual stages in this
              process, each encoder against the unpipelined one from the
              same weights and inputs at dropout 0 (output row cosine >=
              0.9999, every gradient's cosine >= 0.999, no plain version):
              DINO ViT-S/8's 6-block student at pp = 2, M = 2 on the globals
              (256, 145), the packed locals (128, 148, block 37) and fused
              (B4), and at pp = 3, V = 2, M = 4 on both; ViT-B/16's 12
              blocks at 384 px (B3, pp = 4, M = 4) and 512 px (B2, pp = 2,
              V = 2, M = 2), batch 64; each kernel's launches counted (one
              a block and microbatch), both ways timed, the bubble fraction
16. exp2 probe — ``vit_ssl_tpu_torch/scripts/exp2_probe.py``: P1
              (``blockwise_fwd_exp2``) against B2's forward, both timed; P1
              against its plain version
17. P2 times — kernel, plain, the library pair (``torch.where`` dropout
              then ``F.linear``) and bound at T = 37120, 1536 -> 384 and at
              ViT-B/16's T = 36928, 3072 -> 768, bf16, with the wrapper's
              host microseconds a call and a profile of each entry
18. dropout-epilogue probe —
              ``vit_ssl_tpu_torch/scripts/dropout_epilogue_probe.py``, P2's
              path: the epilogue FFN checked against the plain FFN, its five
              legs timed, the derived lines and the retire rule's verdict
19. B1 at ViT-B/16's 224-px shape — kernel, plain, SDPA and bound of
              B1's three entries at (1024, 197, 12 x 64) bf16
20. ViT-B/16 trainer — configs/vit_b_imagenet.yaml composed by the port as
              written (remat on, batch 1024, 224 px, 1000 classes, device
              augmentation; its supervised evaluation every epoch), through
              ``SupervisedTrainer.fit(2)`` over 2600 in-memory uint8 images
              (3 train and 1 val steps an epoch) and a resumed epoch 3:
              B1's launches exact in every step (24 training forwards, the
              checkpointed blocks' first forward and their recompute, and
              12 backwards a train step; 12 inference forwards a val step),
              no plain attention, peak memory, the in-loop and warm steps,
              img/s, a profile of one step, agreement with the
              plain-attention step from one cloned state
21. remat against no remat — the same step at batch 128 from one cloned
              state with ``parallel.remat`` on and off: agreement, both
              peak memories and both device-busy times
21a. V-MoE ViT-B/16 — configs/vit_b_imagenet.yaml with MOE_OVERRIDES (8
              experts in every 2nd block, routed per image, top-2, capacity
              factor 1.25; V-MoE-B/16 "every-2") through
              ``SupervisedTrainer.fit(1)`` (2 train steps, 1 val step), B1's
              launches exact; warm step, img/s, device busy, peak memory,
              ``moe_dropped_frac``; one step against plain attention: the
              router loss, the training bars with the routing pinned to the
              kernel step's, the routing's fidelity to fp64 attention
21b. patch dropout — the ViT-B/16 224 step with ``model.patch_dropout=0.5``
              at batch 1024 against plain attention, every B1 call at N =
              99; device busy; then B1's training entries at (1024, 99,
              12 x 64): kernel, plain, SDPA and bound
21c. visualizers — the three scripts of ``vit_ssl_tpu_torch.scripts``
              through their ``main`` on the trainer phases' run directories:
              the attention map of the ViT-B/16 best_model (11 B1 inference
              forwards at (1, 197, 12 x 64)) and the SimMIM reconstruction (6
              at (1, 144, 6 x 64)), each within row cosine 0.999 of
              ``model.use_flash_attention=false``; the 3D UMAP of the DINO
              run over a PNG folder (6 B1 forwards a feature batch), its
              embedding finite; wall seconds; B1 at the two batch-1 shapes:
              kernel, plain, SDPA, host microseconds and bound
22. a JSON line describing every kernel (B4 once at each width), then the
              JSON ``ok`` line last.

Imports neither JAX nor the JAX package, and needs no PIL, OpenCV or YAML.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np

# DINO ViT-S/8 as configs/dino.yaml composes it (configs/base/*.yaml,
# configs/dino/*.yaml); tests/test_torch_guards.py pins every value here to
# the composed config.
GLOBALS = [
    {"name": "RandomResizedCrop", "params": {"size": 96, "scale": [0.5, 1.0]}},
    {"name": "RandomHorizontalFlip", "params": {}},
    {"name": "ColorJitter", "params": {"brightness": 0.4, "contrast": 0.4,
                                       "saturation": 0.2, "hue": 0.1}},
    {"name": "RandomGrayscale", "params": {"p": 0.2}},
    {"name": "GaussianBlur", "params": {"kernel_size": 7, "sigma": [0.1, 2.0]}},
    {"name": "ToTensor"},
]
LOCALS = [
    {"name": "RandomResizedCrop", "params": {"size": 48, "scale": [0.08, 0.4]}},
    {"name": "RandomHorizontalFlip", "params": {}},
    {"name": "ColorJitter", "params": {"brightness": 0.4, "contrast": 0.4,
                                       "saturation": 0.2, "hue": 0.1}},
    {"name": "GaussianBlur", "params": {"kernel_size": 7, "sigma": [0.1, 2.0]}},
    {"name": "ToTensor"},
]
DINO_VIT_S8 = {
    "training": {
        "type": "dino",
        "batch_size": 128,
        "num_epochs": 100,
        "num_global_views": 2,
        "num_all_views": 6,
        "student_temp": 0.1,
        "teacher_temp": 0.04,
        "teacher_temp_final": 0.07,
        "teacher_temp_scheduler": "cosine",
        "teacher_momentum_start": 0.996,
        "teacher_momentum_final": 1,
        "teacher_dropout": True,
        "warmup_initial_learning_rate": 1e-6,
        "warmup_final_learning_rate": 1e-4,
        "warmup_epochs": 10,
        "optimizer": {"name": "AdamW", "params": {"weight_decay": 0.001}},
        "lr_scheduler": {"main": {"name": "CosineAnnealingLR",
                                  "params": {"eta_min": 1e-6}}},
    },
    "model": {
        "in_channels": 3,
        "embed_dim": 384,
        "num_blocks": 6,
        "num_heads": 6,
        "mlp_dim": 1536,
        "patch_size": 8,
        "dropout": 0.1,
        "fast_dropout": True,
        "use_fused_mlp": False,
        "compute_dtype": "bfloat16",
        "output_dim": 16384,
        "center_momentum": 0.9,
        "dino_pack_locals": True,
    },
    "data": {"img_size": 96, "local_img_size": 48, "device_augment": True},
    "transforms": {"globals": GLOBALS, "locals": LOCALS},
}
# The supervised ViT-B/16 at 384 px: configs/vit_b_imagenet.yaml composed
# with data.img_size=384 parallel.remat=false training.batch_size=64 (one
# card's share of the global batch of 1024, which fits without remat: the
# legs time the step without its second forward);
# tests/test_torch_guards.py pins every value here to that composition.
SUPERVISED_TRAIN = [
    {"name": "RandomResizedCrop", "params": {"size": 384, "scale": [0.9, 1.0]}},
    {"name": "RandomHorizontalFlip", "params": {}},
    {"name": "ToTensor"},
]
VIT_B16_384 = {
    "training": {
        "type": "supervised",
        "batch_size": 64,
        "num_epochs": 90,
        "warmup_epochs": 5,
        "warmup_initial_learning_rate": 1e-6,
        "warmup_final_learning_rate": 1e-4,
        "optimizer": {"name": "AdamW", "params": {"weight_decay": 0.001}},
        "lr_scheduler": {"main": {"name": "CosineAnnealingLR",
                                  "params": {"eta_min": 1e-6}}},
    },
    "model": {
        "in_channels": 3,
        "embed_dim": 768,
        "num_blocks": 12,
        "num_heads": 12,
        "mlp_dim": 3072,
        "patch_size": 16,
        "num_classes": 1000,
        "dropout": 0.1,
        "fast_dropout": True,
        "use_flash_attention": True,
        "use_fused_mlp": False,
        "compute_dtype": "bfloat16",
    },
    "data": {"img_size": 384, "device_augment": True, "val_split": 0.04},
    "parallel": {"remat": False},
    "transforms": {"train": SUPERVISED_TRAIN},
}


def supervised_config(img: int):
    """VIT_B16_384 at another resolution: its image and its crop size."""
    cfg = copy.deepcopy(VIT_B16_384)
    cfg["data"]["img_size"] = img
    cfg["transforms"]["train"][0]["params"]["size"] = img
    return cfg


# The same ViT-B/16 at 384 px with model.use_fused_mlp=true: every FFN is
# kernel B4 at d_model 768, d_ff 3072; tests/test_torch_guards.py pins it to
# the same composition with that override.
VIT_B16_384_FUSED = copy.deepcopy(VIT_B16_384)
VIT_B16_384_FUSED["model"]["use_fused_mlp"] = True
# The same ViT-B/16 at 512 px, N = (512/16)^2 + 1 = 1025: past B1's and B3's
# 1024, so every block runs kernel B2; tests/test_torch_guards.py pins it to
# configs/vit_b_imagenet.yaml composed with data.img_size=512
# parallel.remat=false training.batch_size=64.
VIT_B16_512 = supervised_config(512)
# ViT-B/16 at 224 px as configs/vit_b_imagenet.yaml is written: remat on,
# the global batch of 1024 on one card; tests/test_torch_guards.py pins every
# value here to the port's composition of it
VIT_B16_224 = copy.deepcopy(VIT_B16_384)
VIT_B16_224["training"].update(batch_size=1024, criterion={"name": "CrossEntropyLoss"})
VIT_B16_224["data"].update(img_size=224, dataset_name="imagefolder")
VIT_B16_224["parallel"]["remat"] = True
VIT_B16_224["transforms"]["train"][0]["params"]["size"] = 224
VIT_B16_224["metrics"] = ["Accuracy", "F1Score", "Recall", "Precision"]
# no override: the supervised evaluation writes each epoch's predictions;
# 2600 in-memory images make 3 train steps (2496 images) and 1 val step
# (104) an epoch at the config's val_split 0.04
VIT_B16_224_OVERRIDES = []
VIT_B16_224_IMAGES = 2600
REMAT_BATCH = 128
# configs/finetune.yaml at DINO ViT-S/8's width (the base model, patch 8 at
# 96 px), taking phase 9a's DINO best_model through the extended transfer
# with the backbone frozen until epoch 2; tests/test_torch_guards.py pins
# FINETUNE_S8 to the port's composition with FINETUNE_OVERRIDES
FINETUNE_OVERRIDES = ["model.patch_size=8", "data.img_size=96",
                      "training.extended_transfer=true", "training.freeze_backbone=true",
                      "+freeze_backbone_epochs=2", "data.device_augment=true",
                      "eval.interval=1"]
FINETUNE_S8 = {
    "training": {"type": "finetune", "batch_size": 128, "extended_transfer": True,
                 "freeze_backbone": True, "warmup_epochs": 10,
                 "optimizer": {"name": "AdamW", "params": {"weight_decay": 0.001}},
                 "criterion": {"name": "CrossEntropyLoss"}},
    "model": {key: DINO_VIT_S8["model"][key] for key in (
        "in_channels", "embed_dim", "num_blocks", "num_heads", "mlp_dim", "patch_size",
        "dropout", "fast_dropout", "use_fused_mlp", "compute_dtype")},
    "data": {"img_size": 96, "device_augment": True, "val_split": 0.2},
    "parallel": {"remat": False},
    "freeze_backbone_epochs": 2,
    "transforms": {"train": [
        {"name": "RandomResizedCrop", "params": {"size": 96, "scale": [0.9, 1.0]}},
        {"name": "RandomHorizontalFlip", "params": {}},
        {"name": "ToTensor"}]},
    "metrics": ["Accuracy"],
}
FINETUNE_S8["model"]["num_classes"] = 10
# SimMIM ViT-S/16 at 192 px as configs/simmim.yaml composes it (N = 144, no
# CLS token, half the patches masked); tests/test_torch_guards.py pins every
# value here to the port's composition, which runs as written (its
# evaluation after every epoch). 400 in-memory images
# make 3 train steps (320 images, the last padded) and 1 val step (80) an
# epoch at the config's val_split 0.2
SIMMIM_VIT_S16 = {
    "training": {"type": "simmim", "batch_size": 128, "num_epochs": 130,
                 "warmup_epochs": 10, "warmup_initial_learning_rate": 1e-6,
                 "warmup_final_learning_rate": 1e-4,
                 "optimizer": {"name": "AdamW", "params": {"weight_decay": 0.001}},
                 "criterion": {"name": "L1Loss"},
                 "lr_scheduler": {"main": {"name": "CosineAnnealingLR",
                                           "params": {"eta_min": 1e-6}}}},
    "model": {key: DINO_VIT_S8["model"][key] for key in (
        "in_channels", "embed_dim", "num_blocks", "num_heads", "mlp_dim", "dropout",
        "fast_dropout", "use_fused_mlp", "compute_dtype")},
    "data": {"dataset_name": "stl10", "img_size": 192, "val_split": 0.2},
    "parallel": {"remat": False},
    "transforms": {"train": [
        {"name": "RandomResizedCrop", "params": {"size": 192, "scale": [0.9, 1.0]}},
        {"name": "RandomHorizontalFlip", "params": {}},
        {"name": "ToTensor"}]},
    "metrics": ["PSNR", "SSIM"],
}
SIMMIM_VIT_S16["model"].update(patch_size=16, mask_ratio=0.5, use_flash_attention=True)
SIMMIM_OVERRIDES = []
SIMMIM_IMAGES = 400
FINETUNE_IMAGES = 1300  # in-memory uint8 96 x 96 x 3 images: 1040 train, 260 val
GLOBAL_BATCH = 1024  # configs/vit_b_imagenet.yaml's training.batch_size
IMAGENET_TRAIN = 1_281_167  # images of ImageNet-1k's train split
SERVE_BATCH = 128
STL10_UNLABELED = 100_000  # images an epoch of configs/dino's dataset holds
TIMED_STEPS = 10

# H100 SXM data sheet (700 W): memory rate and dense peaks by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

# B1's inference forward at batch 1: the attention visualizer on ViT-B/16 at
# 224 px, the SimMIM visualizer at 192 px
VIT_B_B1_ONE = (1, 197, 12, 64, "bfloat16", 0)
SIMMIM_B1_ONE = (1, 144, 6, 64, "bfloat16", 0)
# B1 in the orbax phase's step from the JAX DINO fixture
# (tests/torch_orbax_fixtures/fixture_spec.py: batch 4, 16-px globals and 8-px
# locals at patch 8, one head of 32, fp32): the globals (8, 5) in the training
# and inference forwards, the packed locals (4, 8, block 2) in both and in
# the backward
ORBAX_FIXTURE_B1_CASES = [(8, 5, 1, 32, "float32", 0), (4, 8, 1, 32, "float32", 2)]
# (batch, seq, heads, head_dim, dtype, block_size): the serving shape first
ATTENTION_CASES = [
    (128, 145, 6, 64, "bfloat16", 0),
    (128, 145, 6, 64, "float32", 0),
    (128, 148, 6, 64, "bfloat16", 37),
    (512, 37, 6, 64, "bfloat16", 0),
    (64, 197, 12, 64, "bfloat16", 0),
    (8, 1024, 6, 64, "bfloat16", 0),
    (16, 145, 12, 32, "bfloat16", 0),
    (16, 145, 12, 32, "float32", 0),
    (16, 148, 3, 128, "bfloat16", 37),
    (16, 148, 3, 128, "float32", 37),
    (4, 1, 6, 64, "bfloat16", 0),
    (4, 1, 6, 64, "float32", 0),
    (1024, 197, 12, 64, "bfloat16", 0),
    (1024, 197, 12, 64, "float32", 0),
    (128, 144, 6, 64, "bfloat16", 0),
    VIT_B_B1_ONE,
    SIMMIM_B1_ONE,
    *ORBAX_FIXTURE_B1_CASES,
]
# B1's shapes at tp = 2 (TP_VIRTUAL: one rank's 3 of DINO ViT-S/8's 6
# heads, 6 of ViT-B/16's 12), bf16: the student globals, the packed locals,
# ViT-B/16 at 224 px
TP_B1_CASES = [(256, 145, 3, 64, "bfloat16", 0), (128, 148, 3, 64, "bfloat16", 37),
               (1024, 197, 6, 64, "bfloat16", 0)]
# B1's shapes inside the pipeline phase's stages (microbatches of DINO
# ViT-S/8's student, 6 heads), bf16: the globals (256, 145) at M = 2 and 4,
# the packed locals (128, 148, block 37) at M = 2 and 4
PIPE_B1_CASES = [(128, 145, 6, 64, "bfloat16", 0), (64, 145, 6, 64, "bfloat16", 0),
                 (64, 148, 6, 64, "bfloat16", 37), (32, 148, 6, 64, "bfloat16", 37)]
# The training forward and backward: the student globals and packed locals
# first (bf16 and fp32), then the other shapes the kernels take, the tp = 2
# shapes, the pipeline's microbatch shapes, then the orbax fixture's
TRAIN_CASES = [
    (256, 145, 6, 64, "bfloat16", 0),
    (256, 145, 6, 64, "float32", 0),
    (128, 148, 6, 64, "bfloat16", 37),
    (128, 148, 6, 64, "float32", 37),
    (512, 37, 6, 64, "bfloat16", 0),
    (16, 145, 12, 32, "bfloat16", 0),
    (16, 148, 3, 128, "bfloat16", 37),
    (8, 1024, 6, 64, "bfloat16", 0),
    (4, 1, 6, 64, "bfloat16", 0),
    (1024, 197, 12, 64, "bfloat16", 0),
    (1024, 197, 12, 64, "float32", 0),
    (128, 144, 6, 64, "bfloat16", 0),
    (1024, 99, 12, 64, "bfloat16", 0),
    *TP_B1_CASES,
    *PIPE_B1_CASES,
    *ORBAX_FIXTURE_B1_CASES,
]
# ViT-B/16 at 224 px (configs/vit_b_imagenet.yaml): B1's shape on that path
VIT_B_B1_CASE = (1024, 197, 12, 64, "bfloat16", 0)
# SimMIM ViT-S/16 at 192 px (configs/simmim.yaml): every forward and backward
SIMMIM_B1_CASE = (128, 144, 6, 64, "bfloat16", 0)
# ViT-B/16 at 224 px with model.patch_dropout=0.5: the CLS token and 98 of
# 196 patches, every training forward and backward
PATCH_B1_CASE = (1024, 99, 12, 64, "bfloat16", 0)
# gradients and statistics: max |kernel - plain| over max |plain|. bf16: p
# and ds round to bf16 on both sides and may land on either side of a tie;
# fp32: sums in another order
GRAD_REL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
STATS_REL_TOL = 1e-5
# B1's bf16 forward and backward at the main paths' shapes, (entry, batch,
# seq, block_size) -> ms, on the mma.sync bodies that attention_fwd_sm90.cuh
# and attention_bwd_sm90.cuh replaced, as this script measured them through
# the wrapper on an NVIDIA H100 80GB HBM3 at 700 W; the teacher's (256, 145)
# inference forward, which this script did not time then, as
# vit_ssl_tpu_torch/scripts/b3_turns.py --kernel b1 measured that body's C
# entry alone beside the new one. Printed beside this run's times, never in
# the kernels line
B1_MMA_SYNC_MS = {("fwd", 128, 145, 0): 0.0828, ("fwd", 256, 145, 0): 0.1568,
                  ("fwd_stats", 256, 145, 0): 0.1589, ("fwd_stats", 128, 148, 37): 0.0767,
                  ("bwd", 256, 145, 0): 0.3208, ("bwd", 128, 148, 37): 0.1429}

# Kernel B3 (head-major, no mask), (batch, heads, seq, head_dim, dtype):
# ViT-B/16 at 384 px first (bf16, fp32), then N = 1, N = 1024 and ragged N
# with the other head dims, and the 384-px shape at tp = 2 (6 heads a rank)
TP_B3_CASE = (64, 6, 577, 64, "bfloat16")
# ... and ViT-B/16 at 384 px in the pipeline phase's microbatches (64 / M = 4)
PIPE_B3_CASE = (16, 12, 577, 64, "bfloat16")
FUSED_CASES = [
    (64, 12, 577, 64, "bfloat16"),
    (64, 12, 577, 64, "float32"),
    (4, 12, 1, 64, "bfloat16"),
    (4, 12, 1, 64, "float32"),
    (8, 12, 1024, 64, "bfloat16"),
    (8, 12, 1024, 64, "float32"),
    (16, 4, 70, 32, "bfloat16"),
    (16, 4, 70, 32, "float32"),
    (16, 2, 203, 128, "bfloat16"),
    (16, 2, 203, 128, "float32"),
    TP_B3_CASE,
    PIPE_B3_CASE,
]

# Kernel B2 (blockwise flash attention), (batch, heads, seq, head_dim,
# dtype): ViT-B/16 at 512 px first (bf16, fp32), then N = 1, a ragged
# N <= 1024, N = 2048 and 4096, head dims 32 and 128, and the 512-px shape
# at tp = 2 (6 heads a rank)
TP_B2_CASE = (64, 6, 1025, 64, "bfloat16")
# ... and ViT-B/16 at 512 px in the pipeline phase's microbatches (64 / M = 2)
PIPE_B2_CASE = (32, 12, 1025, 64, "bfloat16")
BLOCKWISE_CASES = [
    (64, 12, 1025, 64, "bfloat16"),
    (64, 12, 1025, 64, "float32"),
    (4, 12, 1, 64, "bfloat16"),
    (4, 12, 1, 64, "float32"),
    (8, 12, 777, 64, "bfloat16"),
    (8, 12, 777, 64, "float32"),
    (8, 6, 2048, 64, "bfloat16"),
    (2, 6, 2048, 64, "float32"),
    (4, 6, 4096, 64, "bfloat16"),
    (1, 6, 4096, 64, "float32"),
    (16, 4, 300, 32, "bfloat16"),
    (16, 4, 300, 32, "float32"),
    (8, 2, 1100, 128, "bfloat16"),
    (8, 2, 1100, 128, "float32"),
    TP_B2_CASE,
    PIPE_B2_CASE,
]
# B2's lse: max |kernel - plain| over max |plain| (sums in another order;
# the bf16 kernels' exponentials are ex2.approx or expf)
LSE_REL_TOL = 1e-5
# B2's gradients are held to GRAD_REL_TOL of max|plain| with the
# denominator floored at this share of the scale of the terms that cancel
# in dq and dk, scale max_i |do_i| max_j |v_j| max(|q|, |k|) (row norms):
# they are sums of p (dp - delta) scale, and delta (from do and o) cancels
# dp only to rounding, so where the exact gradient is 0 (N = 1, one key)
# both sides give that rounding noise
B2_GRAD_FLOOR = 1e-3


def b2_grad_errs(q, k, v, do, scale, got, want):
    """Each of dq, dk, dv: max |kernel - plain| over the floored max|plain|
    (B2_GRAD_FLOOR)."""
    def top(x):
        return float(x.float().abs().max())

    floor = B2_GRAD_FLOOR * scale * top(do.float().norm(dim=-1)) \
        * top(v.float().norm(dim=-1)) * max(top(q), top(k))
    return [max_abs(g, w) / max(top(w), floor, 1e-30) for g, w in zip(got, want)]

# Kernel B4 (fused MLP) at the token counts of the main paths: the student
# globals and the teacher (256 x 145), the packed locals (128 x 148), a
# served batch (128 x 145) and a short one (37 x 145); then T = 1 and a
# ragged T
MLP_ROWS = [37120, 18944, 18560, 5365, 1, 70]
MLP_DIMS = (384, 1536)  # d_model, d_ff of DINO ViT-S/8
# B4 at the other widths it is built for, (T, d_model, d_ff): ViT-B/16 at
# 384 px (64 x 577 tokens) and ViT-L/16 at 224 px (64 x 197), each with a
# short ragged T; then the local widths at tp = 2 (half of d_ff a rank):
# DINO ViT-S/8's 384 -> 768 at the student's two token counts
# (TP_B4_CASES) and a ragged T, ViT-B/16's 768 -> 1536 at a full and a
# ragged T
TP_B4_CASES = [(37120, 384, 768), (18944, 384, 768)]
MLP_WIDE_CASES = [(36928, 768, 3072), (70, 768, 3072), (12608, 1024, 4096),
                  (1, 1024, 4096), *TP_B4_CASES, (70, 384, 768), (12608, 768, 1536),
                  (70, 768, 1536)]
KEEP_PROB = 0.9  # 1 - model.dropout
# outputs and gradients: max |kernel - plain| over max |plain|. bf16: h and
# dpre round to bf16 on both sides and may land on either side of a tie;
# fp32: sums in another order
MLP_REL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
MLP_GRADS = ("dx", "dw1", "db1", "dw2", "db2")  # fused_mlp_bwd's outputs
# B4's bf16 kernels (csrc/mlp_gemm_sm90.cuh; every kernel that
# ops/fused_mlp.py::HOPPER_BODIES names): the forward's fc1 and fc2, the
# backward's dh, dx and weight-gradient products
B4_BODIES = ("mlp_fc1_sm90_kernel", "mlp_fc2_sm90_kernel", "mlp_dh_sm90_kernel",
             "mlp_dx_sm90_kernel", "mlp_wgrad_sm90_kernel")
# P2's bf16 kernels by entry (csrc/masked_matmul.cu on mlp_gemm_sm90.cuh's
# product; ops/masked_matmul.py::HOPPER_BODIES): the forward's masked
# product, the backward's dh and weight-gradient products; the backward
# also runs the ordered reduction P2_REDUCTION. The mma.sync bodies they
# replaced must not appear in a profile: P2_MMA_SYNC_BODIES.
P2_BODIES = {"masked_mm_fwd": ("masked_mm_fwd_sm90_kernel",),
             "masked_mm_bwd": ("masked_mm_dh_sm90_kernel", "masked_mm_wgrad_sm90_kernel")}
P2_REDUCTION = "reduce_splits"
P2_MMA_SYNC_BODIES = ("masked_mm_bf16", "mlp_weights_bf16")


def fail(msg: str) -> None:
    """Print ``msg`` on both streams (a caller that keeps only the end of
    standard error still reads why) and exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def ptxas_lines(log: str, nvcc: str):
    """``-Xptxas -v``'s registers, spills and serialisation notes, each
    prefixed by its kernel, demangled by the toolkit's ``cu++filt`` (beside
    ``nvcc``)."""
    pattern = r"(?:Compiling entry|the) function '(\w+)'"
    mangled = list(dict.fromkeys(re.findall(pattern, log)))
    names = subprocess.run(
        [str(Path(nvcc).with_name("cu++filt")), "-p", *mangled],
        check=True, capture_output=True, text=True).stdout.splitlines()
    if len(names) != len(mangled):
        fail(f"cu++filt demangled {len(names)} of {len(mangled)} kernel names")
    # drop the namespaces: "<unnamed>::sm90::name<(int)64>" -> "name<(int)64>"
    demangled = {m: re.sub(r"(?:<unnamed>|\(anonymous namespace\)|\w+)::", "", n)
                 for m, n in zip(mangled, names)}
    kernel = ""
    for line in log.splitlines():
        entry = re.search(pattern, line)
        if entry:
            kernel = demangled[entry.group(1)]
        if "registers" in line or "spill" in line:
            yield f"{kernel}: {line.strip()}"
        elif "Performance Loss" in line:
            note = line.split(" for the function")[0].split(" in the function")[0]
            yield f"{kernel}: {note.strip()}"


# ptxas' notes that it serialised a kernel's wgmma instructions (a product
# under a branch; accumulator registers touched while a group is in flight)
SERIALISED_WGMMA = ("C7514", "C7515", "C7520")


def hopper_faults(lines):
    """The ``ptxas_lines`` of Hopper bodies (``*_sm90_kernel``) that show a
    spill or serialised wgmma instructions."""
    faults = []
    for line in lines:
        if "_sm90_kernel" not in line.split(": ")[0]:
            continue
        spills = re.findall(r"(\d+) bytes spill", line)
        if any(int(x) for x in spills) or any(c in line for c in SERIALISED_WGMMA):
            faults.append(line)
    return faults


def registers_and_spills(lines, bodies):
    """From ``ptxas_lines``: per kernel whose name holds one of ``bodies``,
    its registers and spill bytes (stores, loads)."""
    found = {}
    for line in lines:
        kernel, _, text = line.partition(": ")
        if not any(body in kernel for body in bodies):
            continue
        row = found.setdefault(kernel, {})
        used = re.search(r"Used (\d+) registers", text)
        if used:
            row["registers"] = int(used.group(1))
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
        if spills:
            row["spill_stores"], row["spill_loads"] = map(int, spills.groups())
    return found


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device milliseconds per call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
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


def host_us(fn, calls: int = 100) -> float:
    """Host microseconds a call of ``fn``: ``calls`` back-to-back calls with
    no synchronisation inside (the launch queue holds them all)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def b1_bare(torch, fa, entry, xq, xk, xv, h, scale, bs, fn=None, grad=()):
    """A no-argument launch of B1's C entry ``entry`` (``fn``: that entry of
    another library; default this checkout's) on outputs allocated once (the
    statistics, or the backward's delta, zeroed once), returning them: the
    kernel's device time without the wrapper's checks and allocations, which
    at DINO's shapes take about as long on the host as the kernel takes on
    the card. The backward (``fa.KERNEL_BWD``) takes ``grad`` = (do in the
    input dtype, contiguous; the training forward's statistics) and returns
    (dq, dk, dv)."""
    b, n, hd = xq.shape
    rows = -(-n // fa.STATS_ROWS) * fa.STATS_ROWS
    bufs = [torch.empty_like(xq)]
    if entry == fa.KERNEL_TRAIN:
        bufs.append(torch.zeros(b, h, rows, 2, device=xq.device))
    inputs = (xq, xk, xv)
    if entry == fa.KERNEL_BWD:
        bufs = [torch.empty_like(xq) for _ in range(3)]
        inputs = (xq, xk, xv, *grad)
    # the backward's delta: rows past n stay zero, the kernel writes no others
    scratch = [torch.zeros(b, h, rows, device=xq.device)] if entry == fa.KERNEL_BWD else []
    ptrs = [x.data_ptr() for x in (*inputs, *bufs, *scratch)]
    fn = fn or fa._kernel_fn(entry)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        if fn(*ptrs, b, n, h, hd // h, 1, scale, bs, stream):
            fail(f"{entry} launch failed")
        return bufs
    call.scratch = scratch  # alive as long as the call
    return call


def b1_forward_row(torch, fa, entry, label, xq, xk, xv, h, scale, bs, bound):
    """B1's bf16 forward ``entry`` at one shape: ``ms`` through the wrapper,
    back to back (twice, around the plain version's and SDPA's on views of
    the same storage, a boolean block-diagonal mask when bs > 0), the
    wrapper's host microseconds a call, and ``bare_ms``, the C entry alone
    (b1_bare: the kernel without the wrapper's host work). Prints them
    beside ``bound`` (ms, by) and the mma.sync body's recorded time, and
    returns the row of the kernels line."""
    import torch.nn.functional as F

    b, n, hd = xq.shape
    d = hd // h
    wrapper = {fa.KERNEL: fa.attention_nhd_fwd, fa.KERNEL_TRAIN: fa.attention_nhd_fwd_stats}[entry]
    plain = {fa.KERNEL: lambda: fa.attention_nhd_reference(xq, xk, xv, h, scale, bs),
             fa.KERNEL_TRAIN: lambda: (
                 fa.attention_nhd_reference(xq, xk, xv, h, scale, bs),
                 fa.attention_nhd_stats_reference(xq, xk, h, scale, bs))}[entry]
    heads = [x.view(b, n, h, d).transpose(1, 2) for x in (xq, xk, xv)]
    mask = None
    if bs:
        block = torch.arange(n, device="cuda") // bs
        mask = block[:, None] == block[None, :]
    first = cuda_ms(lambda: wrapper(xq, xk, xv, h, scale, bs))
    row = {
        "plain_ms": cuda_ms(plain, iters=10),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            *heads, attn_mask=mask, scale=scale)),
        "bare_ms": cuda_ms(b1_bare(torch, fa, entry, xq, xk, xv, h, scale, bs)),
        "wrapper_host_us": host_us(lambda: wrapper(xq, xk, xv, h, scale, bs)),
    }
    second = cuda_ms(lambda: wrapper(xq, xk, xv, h, scale, bs))
    form = fa.attention_nhd_form(n)
    key = ("fwd" if entry == fa.KERNEL else "fwd_stats", b, n, bs)
    dtype = str(xq.dtype).removeprefix("torch.")
    print(f"  {entry} ({b},{n},{h}x{d}) {dtype} block_size={bs}{label} ({form}): "
          f"kernel {first:.4f} / {second:.4f} ms through the wrapper back to back, "
          f"{row['wrapper_host_us']:.1f} us a call on the host; the C entry alone "
          f"{row['bare_ms']:.4f} ms; the mma.sync body it replaced "
          f"{B1_MMA_SYNC_MS.get(key, 'not measured')} ms (recorded), plain "
          f"{row['plain_ms']:.4f} ms, "
          f"SDPA{' (boolean attn_mask)' if bs else ''} {row['library_ms']:.4f} ms, "
          f"bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
    return {"ms": min(first, second), "ms_readings": [first, second], **row,
            "bound_ms": bound[0], "bound_by": bound[1], "form": form,
            "shape": [b, n, h, d, bs]}


def _bound(bytes_moved, ops, dtype):
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def attention_bound(b, n, h, d, dtype, block_size):
    """(bound_ms, bound_by) of the inference forward: the larger of bytes
    moved (q, k, v read once, o written once) over the memory rate and the
    two products' operations that these inputs need (only the unmasked
    block when block_size > 0) over the peak rate for the input type."""
    itemsize = 2 if dtype == "bfloat16" else 4
    keys = min(block_size, n) if block_size else n
    return _bound(4 * b * n * h * d * itemsize, 4 * b * h * n * keys * d, dtype)


def attention_train_bounds(b, n, h, d, dtype, block_size):
    """{"fwd": (ms, by), "bwd": (ms, by)} of the training forward (q, k, v
    read, o and the fp32 (m, 1/l) statistics written; two products) and the
    backward (q, k, v, do and the statistics read, dq, dk, dv written; five
    products: the scores again, dv, dp, dq, dk)."""
    itemsize = 2 if dtype == "bfloat16" else 4
    keys = min(block_size, n) if block_size else n
    act = b * n * h * d * itemsize
    stats = b * h * n * 2 * 4
    product = 2 * b * h * n * keys * d
    return {"fwd": _bound(4 * act + stats, 2 * product, dtype),
            "bwd": _bound(7 * act + stats, 5 * product, dtype)}


def blockwise_bounds(b, h, n, d, dtype):
    """{"fwd", "dq", "dkv": (ms, by)} of kernel B2's three entries on
    (B, H, N, D): attention_train_bounds' arithmetic with lse one fp32 a
    row. The forward reads q, k, v and writes o and lse: two products. The
    dq kernel reads q, k, v, o, do and lse and writes dq and delta: three
    products (the scores, dp, dq). The dk/dv kernel reads q, k, v, do, lse
    and delta and writes dk and dv: four products (the scores, dp, dv,
    dk)."""
    itemsize = 2 if dtype == "bfloat16" else 4
    act = b * h * n * d * itemsize
    row = b * h * n * 4
    product = 2 * b * h * n * n * d
    return {"fwd": _bound(4 * act + row, 2 * product, dtype),
            "dq": _bound(6 * act + 2 * row, 3 * product, dtype),
            "dkv": _bound(6 * act + 2 * row, 4 * product, dtype)}


def mlp_bounds(t, d, d_ff, dtype, mask=True, pre=True):
    """{"fwd": (ms, by), "bwd": (ms, by)} of kernel B4 over t tokens. The
    forward reads x, the weights and biases and (with dropout) the 1-byte
    keep-mask, and writes out and (training) pre: two products. The
    backward reads x, do, pre, the weights and the mask, and writes dx and
    the four weight and bias gradients: four products."""
    itemsize = 2 if dtype == "bfloat16" else 4
    weights = 2 * d * d_ff + d_ff + d
    mask_bytes = t * d_ff if mask else 0
    fwd_bytes = (2 * t * d + weights + (t * d_ff if pre else 0)) * itemsize
    bwd_bytes = (3 * t * d + t * d_ff + 2 * d * d_ff + weights) * itemsize
    return {"fwd": _bound(fwd_bytes + mask_bytes, 4 * t * d * d_ff, dtype),
            "bwd": _bound(bwd_bytes + mask_bytes, 8 * t * d * d_ff, dtype)}


def mlp_inputs(torch, t, dtype, seed, dims=MLP_DIMS):
    """x (LayerNorm-like), nn.Linear-initialised weights in the nn.Linear
    layout, a dropout16 keep-mask at rate 0.1 and an upstream gradient, at
    ``dims`` = (d_model, d_ff)."""
    d, d_ff = dims
    g = torch.Generator(device="cuda").manual_seed(seed)

    def uniform(*shape, fan_in):
        return ((torch.rand(*shape, generator=g, device="cuda") * 2 - 1)
                / fan_in ** 0.5).to(dtype)

    x = torch.randn(t, d, generator=g, device="cuda").to(dtype)
    w1, b1 = uniform(d_ff, d, fan_in=d), uniform(d_ff, fan_in=d)
    w2, b2 = uniform(d, d_ff, fan_in=d_ff), uniform(d, fan_in=d_ff)
    mask = torch.randint(0, 65536, (t, d_ff), generator=g, device="cuda") >= 6554
    do = torch.randn(t, d, generator=g, device="cuda").to(dtype)
    return x, w1, b1, w2, b2, mask, do


def unfused_ffn(torch, x, w1, b1, w2, b2, mask, keep_prob):
    """The port's unfused FFN chain (``use_fused_mlp=false``) given the
    keep-mask: F.linear → GELU → dropout16's where/divide → F.linear."""
    import torch.nn.functional as F

    h = F.gelu(F.linear(x, w1, b1))
    if mask is not None:
        h = torch.where(mask, h / keep_prob, h.new_zeros(()))
    return F.linear(h, w2, b2)


def qkv(b, n, h, d, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, n, h * d, generator=g, device="cuda").to(dtype)
            for _ in range(3)]


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def phase_kernels(torch, fa):
    print("== kernels: attention_nhd_fwd against attention_nhd_reference", flush=True)
    for idx, (b, n, h, d, dtype_name, bs) in enumerate(ATTENTION_CASES):
        dtype = getattr(torch, dtype_name)
        xq, xk, xv = qkv(b, n, h, d, dtype, seed=idx)
        scale = 1.0 / d ** 0.5
        out = fa.attention_nhd(xq, xk, xv, h, scale, bs)
        torch.cuda.synchronize()
        ref = fa.attention_nhd_reference(xq, xk, xv, h, scale, bs)
        ok, tol = forward_ok(torch, out, ref, dtype_name)
        body = fa.attention_nhd_form(n) if dtype_name == "bfloat16" else "CUDA cores"
        print(f"  ({b},{n},{h}x{d}) {dtype_name} block_size={bs} ({body}): "
              f"max_abs_err {max_abs(out, ref):.3e} ({tol}) {'ok' if ok else 'MISS'}",
              flush=True)
        if not ok:
            fail(f"attention_nhd_fwd disagrees at ({b},{n},{h}x{d}) {dtype_name}")

    print("== kernels: attention_nhd_fwd_stats and attention_nhd_bwd against "
          "their plain versions", flush=True)
    errors = {}
    for idx, (b, n, h, d, dtype_name, bs) in enumerate(TRAIN_CASES):
        dtype = getattr(torch, dtype_name)
        xq, xk, xv = qkv(b, n, h, d, dtype, seed=50 + idx)
        (do,) = qkv(b, n, h, d, torch.float32, seed=80 + idx)[:1]
        scale = 1.0 / d ** 0.5
        out, stats = fa.attention_nhd_fwd_stats(xq, xk, xv, h, scale, bs)
        grads = fa.attention_nhd_bwd(xq, xk, xv, do, stats, h, scale, bs)
        torch.cuda.synchronize()
        same = torch.equal(out, fa.attention_nhd_fwd(xq, xk, xv, h, scale, bs))
        out_err = float((out.float() - fa.attention_nhd_reference(
            xq, xk, xv, h, scale, bs).float()).abs().max())
        stats_err = rel_err(stats[:, :, :n],
                            fa.attention_nhd_stats_reference(xq, xk, h, scale, bs))
        pad_zero = not bool(stats[:, :, n:].any())
        want = fa.attention_nhd_bwd_reference(xq, xk, xv, do, h, scale, bs)
        grad_errs = [rel_err(g, w) for g, w in zip(grads, want)]
        grad_abs = max(float((g.float() - w.float()).abs().max())
                       for g, w in zip(grads, want))
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        tol = GRAD_REL_TOL[dtype_name]
        ok = (same and stats_err <= STATS_REL_TOL and pad_zero and finite
              and max(grad_errs) <= tol)
        print(f"  ({b},{n},{h}x{d}) {dtype_name} block_size={bs}: output "
              f"{'bit-equal to' if same else 'DIFFERS from'} the inference "
              f"kernel (max_abs_err {out_err:.3e} to plain); stats rel_err "
              f"{stats_err:.3e} (<= {STATS_REL_TOL:g}); dq/dk/dv rel_err "
              + "/".join(f"{e:.3e}" for e in grad_errs)
              + f" (<= {tol:g} of max|ref|) {'ok' if ok else 'MISS'}", flush=True)
        if not ok:
            fail(f"training kernels disagree at ({b},{n},{h}x{d}) {dtype_name}")
        errors[(b, n, h, d, dtype_name, bs)] = (out_err, grad_abs)
    b1_isolation(torch, fa)
    return errors


def b1_isolation(torch, fa):
    """B1's bf16 forward and backward keep to their head and their image:
    with head 1's columns of q, k, v and do all inf and image 1 all NaN,
    heads 0 and 2 of images 0 and 2 equal the plain version of each head
    alone, in both forward entries (forward_ok; their statistics finite)
    and in the backward (dq, dk and dv finite and within GRAD_REL_TOL), at
    N = 145 (one pass, resident backward) and 577 (two passes, streamed).
    Then two calls of each entry bit-equal at the serving and training
    shapes."""
    tol = GRAD_REL_TOL["bfloat16"]
    for n, h in ((145, 3), (577, 3), (197, 12)):
        xq, xk, xv = qkv(3, n, h, 64, torch.bfloat16, seed=90 + n)
        (do,) = qkv(3, n, h, 64, torch.bfloat16, seed=91 + n)[:1]
        for x in (xq, xk, xv, do):
            x.view(3, n, h, 64)[:, :, 1] = float("inf")
            x[1] = float("nan")
        out = fa.attention_nhd_fwd(xq, xk, xv, h, 0.125)
        out_t, stats = fa.attention_nhd_fwd_stats(xq, xk, xv, h, 0.125)
        grads = fa.attention_nhd_bwd(xq, xk, xv, do, stats, h, 0.125)
        torch.cuda.synchronize()
        ok, errs, grad_errs = True, [], []
        for img in (0, 2):
            for head in sorted({0, 2, h - 1}):
                alone = [x.view(3, n, h, 64)[img:img + 1, :, head].contiguous()
                         for x in (xq, xk, xv, do)]
                ref = fa.attention_nhd_reference(*alone[:3], 1, 0.125)
                for got in (out, out_t):
                    got = got.view(3, n, h, 64)[img:img + 1, :, head]
                    ok = ok and forward_ok(torch, got, ref, "bfloat16")[0]
                    errs.append(max_abs(got, ref))
                ok = ok and bool(torch.isfinite(stats[img, head, :n]).all())
                want = fa.attention_nhd_bwd_reference(*alone, 1, 0.125)
                for g, w in zip(grads, want):
                    g = g.view(3, n, h, 64)[img:img + 1, :, head]
                    grad_errs.append(rel_err(g, w))
                    ok = ok and bool(torch.isfinite(g).all()) and grad_errs[-1] <= tol
        print(f"  isolation (3,{n},{h}x64) bfloat16 ({fa.attention_nhd_form(n)} forward, "
              f"{fa.attention_nhd_bwd_form(n, 0, torch.bfloat16)} backward), head 1 all inf, "
              f"image 1 all NaN: heads {sorted({0, 2, h - 1})} of images 0 and 2 against "
              f"each head alone, "
              f"forward max_abs_err {max(errs):.3e}, dq/dk/dv rel_err {max(grad_errs):.3e} "
              f"({tol}) {'ok' if ok else 'MISS'}", flush=True)
        if not ok:
            fail(f"B1 reads past its head or image at N = {n}")
    for b, n, h, d, _, bs in (ATTENTION_CASES[0], TRAIN_CASES[0], TRAIN_CASES[2],
                              VIT_B_B1_CASE):
        xq, xk, xv = qkv(b, n, h, d, torch.bfloat16, seed=95)
        (do,) = qkv(b, n, h, d, torch.bfloat16, seed=96)[:1]
        first, second = (fa.attention_nhd_fwd_stats(xq, xk, xv, h, 0.125, bs)
                         for _ in range(2))
        grads = [fa.attention_nhd_bwd(xq, xk, xv, do, first[1], h, 0.125, bs)
                 for _ in range(2)]
        repeat = (all(torch.equal(a, c) for a, c in zip(first, second))
                  and torch.equal(fa.attention_nhd_fwd(xq, xk, xv, h, 0.125, bs),
                                  fa.attention_nhd_fwd(xq, xk, xv, h, 0.125, bs))
                  and all(torch.equal(a, c) for a, c in zip(*grads)))
        print(f"  two calls of each forward and of the backward at ({b},{n},{h}x{d}) "
              f"block_size={bs} {'bit-equal' if repeat else 'DIFFER'}", flush=True)
        if not repeat:
            fail(f"B1 does not repeat bit for bit at ({b},{n},{h}x{d})")


def heads_qkv(b, h, n, d, dtype, seed, count=3):
    """``count`` contiguous (B, H, N, D) standard-normal tensors."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, h, n, d, generator=g, device="cuda").to(dtype)
            for _ in range(count)]


def phase_fused_kernels(torch, fa):
    """Kernel B3 against its plain versions at every FUSED_CASES shape: the
    inference forward (bf16 atol 1e-2 rtol 1e-2, fp32 atol 1e-5), the
    training forward (output bit-equal to the inference kernel's,
    statistics within STATS_REL_TOL, padding rows zero) and the backward
    fed those statistics (each gradient within GRAD_REL_TOL of max|plain|).
    At ViT-B/16's shape also B1 on the same data in B1's layout: one
    forward body for both layouts in each dtype (fp32: CUDA cores; bf16:
    the Hopper body's two-pass form), so output and statistics bit-equal.
    Then each head kept to its own rows (head 1
    filled with inf at N = 577 and 70; heads 0 and 2 against the plain
    version of each head alone), forward and backward (each gradient within
    GRAD_REL_TOL), and two calls bit-equal, forward and backward (bf16 at
    every head dim, and fp32). Returns, per case, (forward max_abs_err,
    backward max_abs_err)."""
    print("== kernels: fused_attention_fwd, fused_attention_fwd_stats and "
          "fused_attention_bwd against their plain versions", flush=True)
    errors = {}
    for idx, (b, h, n, d, dtype_name) in enumerate(FUSED_CASES):
        dtype = getattr(torch, dtype_name)
        q, k, v = heads_qkv(b, h, n, d, dtype, seed=600 + idx)
        (do,) = heads_qkv(b, h, n, d, torch.float32, seed=650 + idx, count=1)
        scale = 1.0 / d ** 0.5
        out = fa.fused_attention_fwd(q, k, v, scale)
        out_t, stats = fa.fused_attention_fwd_stats(q, k, v, scale)
        grads = fa.fused_attention_bwd(q, k, v, do, stats, scale)
        torch.cuda.synchronize()
        ref = fa.fused_attention_reference(q, k, v, scale)
        fwd_ok, fwd_tol = forward_ok(torch, out, ref, dtype_name)
        same = torch.equal(out, out_t)
        stats_err = rel_err(stats[:, :, :n], fa.fused_attention_stats_reference(q, k, scale))
        pad_zero = not bool(stats[:, :, n:].any())
        want = fa.fused_attention_bwd_reference(q, k, v, do, scale)
        grad_errs = [rel_err(g, w) for g, w in zip(grads, want)]
        grad_abs = max(max_abs(g, w) for g, w in zip(grads, want))
        finite = all(bool(torch.isfinite(x).all()) for x in grads)
        tol = GRAD_REL_TOL[dtype_name]
        ok = (fwd_ok and same and stats_err <= STATS_REL_TOL and pad_zero and finite
              and max(grad_errs) <= tol)
        line = (f"  ({b},{h},{n},{d}) {dtype_name}: forward max_abs_err "
                f"{max_abs(out, ref):.3e} ({fwd_tol}); training output "
                f"{'bit-equal to' if same else 'DIFFERS from'} inference; stats "
                f"rel_err {stats_err:.3e} (<= {STATS_REL_TOL:g}); dq/dk/dv rel_err "
                + "/".join(f"{e:.3e}" for e in grad_errs)
                + f" (<= {tol:g} of max|ref|)")
        if (b, h, n, d, dtype_name) == FUSED_CASES[0]:
            line += ("; the mma.sync backward's dq/dk/dv rel_err "
                     + "/".join(f"{e:.1e}" for e in B3_MMA_SYNC_GRAD_ERRS))
        if (b, h, n, d) == FUSED_CASES[0][:4]:
            def nhd(x):
                return x.transpose(1, 2).reshape(b, n, h * d)
            b1, b1_stats = fa.attention_nhd_fwd_stats(nhd(q), nhd(k), nhd(v), h, scale)
            b1_stats_err = rel_err(stats, b1_stats)
            b1_ok = torch.equal(b1, nhd(out)) and torch.equal(b1_stats, stats)
            ok = ok and b1_ok
            line += (f"; B1 on the same data: max_abs_diff {max_abs(b1, nhd(out)):.3e}, "
                     f"stats rel_diff {b1_stats_err:.3e} (the same body: bit-equal "
                     f"expected)")
        print(line + f" {'ok' if ok else 'MISS'}", flush=True)
        if not ok:
            fail(f"B3 kernels disagree at ({b},{h},{n},{d}) {dtype_name}")
        errors[(b, h, n, d, dtype_name)] = (max_abs(out, ref), grad_abs)
        del q, k, v, do, out, out_t, stats, grads, ref, want
    for n in (577, 70):  # a tile past row n must not read the next head
        q, k, v, do = heads_qkv(2, 3, n, 64, torch.bfloat16, seed=690 + n, count=4)
        for x in (q, k, v, do):
            x[:, 1] = float("inf")
        out = fa.fused_attention_fwd(q, k, v, 0.125)
        out_t, stats = fa.fused_attention_fwd_stats(q, k, v, 0.125)
        grads = fa.fused_attention_bwd(q, k, v, do, stats, 0.125)
        torch.cuda.synchronize()
        # head 1 is NaN in both (inf - inf); the other heads must match
        ok, errs, grad_errs = torch.equal(out[:, 0::2], out_t[:, 0::2]), [], []
        for head in (0, 2):
            alone = [x[:, head:head + 1].contiguous() for x in (q, k, v, do)]
            ref = fa.fused_attention_reference(*alone[:3], 0.125)
            head_ok, _ = forward_ok(torch, out[:, head:head + 1], ref, "bfloat16")
            ok = ok and head_ok and bool(torch.isfinite(stats[:, head, :n]).all())
            errs.append(max_abs(out[:, head:head + 1], ref))
            for g, w in zip(grads, fa.fused_attention_bwd_reference(*alone, 0.125)):
                g = g[:, head:head + 1]
                grad_errs.append(rel_err(g, w))
                ok = ok and bool(torch.isfinite(g).all())
        ok = ok and max(grad_errs) <= GRAD_REL_TOL["bfloat16"]
        print(f"  head isolation (2,3,{n},64) bfloat16, head 1 all inf: heads 0 and 2 "
              f"max_abs_err {errs[0]:.3e} / {errs[1]:.3e} against each head alone; "
              f"their dq/dk/dv rel_err at most {max(grad_errs):.3e} "
              f"(<= {GRAD_REL_TOL['bfloat16']:g}) {'ok' if ok else 'MISS'}", flush=True)
        if not ok:
            fail(f"B3 reads past its head at N = {n}")
    b, h, n, d, _ = FUSED_CASES[0]
    q, k, v = heads_qkv(b, h, n, d, torch.bfloat16, seed=699)
    first, second = (fa.fused_attention_fwd_stats(q, k, v, 0.125) for _ in range(2))
    repeat = all(torch.equal(a, c) for a, c in zip(first, second))
    print(f"  two training forwards at ({b},{h},{n},{d}) bfloat16 "
          f"{'bit-equal' if repeat else 'DIFFER'}", flush=True)
    if not repeat:
        fail("B3's forward does not repeat bit for bit")
    for d, dtype_name in ((32, "bfloat16"), (64, "bfloat16"), (128, "bfloat16"),
                          (64, "float32")):
        heads = 12 * 64 // d
        q, k, v, do = heads_qkv(8, heads, n, d, getattr(torch, dtype_name), seed=698, count=4)
        _, stats = fa.fused_attention_fwd_stats(q, k, v, 1.0 / d ** 0.5)
        first, second = (fa.fused_attention_bwd(q, k, v, do, stats, 1.0 / d ** 0.5)
                         for _ in range(2))
        repeat = all(torch.equal(a, c) for a, c in zip(first, second))
        print(f"  two backwards at (8,{heads},{n},{d}) {dtype_name} "
              f"{'bit-equal' if repeat else 'DIFFER'}", flush=True)
        if not repeat:
            fail(f"B3's backward does not repeat bit for bit at D = {d} {dtype_name}")
    return errors


def max_abs(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def forward_ok(torch, out, ref, dtype_name):
    """(ok, tolerance) of a forward's output against its plain version:
    bf16 atol 1e-2 rtol 1e-2 elementwise (a bf16 ulp is 2^-8 relative),
    fp32 atol 1e-5."""
    err = (out.float() - ref.float()).abs()
    if dtype_name == "bfloat16":
        ok = bool((err <= 1e-2 + 1e-2 * ref.float().abs()).all())
        tol = "atol 1e-2 rtol 1e-2"
    else:
        ok, tol = float(err.max()) <= 1e-5, "atol 1e-5"
    return ok and bool(torch.isfinite(out).all()), tol


def phase_blockwise_kernels(torch, fb):
    """Kernel B2 against its plain versions at every BLOCKWISE_CASES shape:
    the forward (o against the plain version at the kernel's key tile,
    KERNEL_BLOCK_K, by :func:`forward_ok`: in bf16 the output depends on
    the tiling, since p rounds relative to the running max; lse within
    LSE_REL_TOL) and the backward's two kernels with and without an lse
    cotangent (each gradient within GRAD_REL_TOL of max|plain|, floored as
    B2_GRAD_FLOOR says, from the same o and lse, and bit-equal on a second
    call: no atomics); the forward bit-equal on a second call too, and in
    bf16 P1 against its plain version at the same tile (bit-equal on a
    second call); then :func:`blockwise_head_isolation`. Returns, per case,
    the max abs errors of o, lse, dq and max(dk, dv) without dlse."""
    print("== kernels: blockwise_fwd, blockwise_bwd_dq and blockwise_bwd_dkv "
          "against their plain versions", flush=True)
    errors = {}
    for idx, (b, h, n, d, dtype_name) in enumerate(BLOCKWISE_CASES):
        dtype = getattr(torch, dtype_name)
        q, k, v = heads_qkv(b, h, n, d, dtype, seed=800 + idx)
        (do,) = heads_qkv(b, h, n, d, torch.float32, seed=850 + idx, count=1)
        dlse = torch.randn(b, h, n, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(900 + idx))
        scale = 1.0 / d ** 0.5
        out, lse = fb.blockwise_attention_fwd(q, k, v, scale)
        torch.cuda.synchronize()
        ref, ref_lse = fb.blockwise_attention_reference(q, k, v, scale, fb.KERNEL_BLOCK_K)
        fwd_ok, fwd_tol = forward_ok(torch, out, ref, dtype_name)
        lse_err = rel_err(lse, ref_lse)
        again = fb.blockwise_attention_fwd(q, k, v, scale)
        same = torch.equal(again[0], out) and torch.equal(again[1], lse)
        ok = fwd_ok and lse_err <= LSE_REL_TOL and same
        line = (f"  ({b},{h},{n},{d}) {dtype_name}: o max_abs_err {max_abs(out, ref):.3e} "
                f"({fwd_tol}, plain at block_k {fb.KERNEL_BLOCK_K}); lse rel_err "
                f"{lse_err:.3e} (<= {LSE_REL_TOL:g}), repeat "
                + ("bit-equal" if same else "DIFFERS"))
        if dtype_name == "bfloat16":  # P1, the same body in the exp2 form
            out2, lse2 = fb.blockwise_attention_fwd_exp2(q, k, v, scale)
            again = fb.blockwise_attention_fwd_exp2(q, k, v, scale)
            torch.cuda.synchronize()
            ref2, ref2_lse = fb.blockwise_attention_exp2_reference(
                q, k, v, scale, fb.KERNEL_BLOCK_K)
            p1_ok, _ = forward_ok(torch, out2, ref2, dtype_name)
            p1_lse = rel_err(lse2, ref2_lse)
            p1_same = torch.equal(again[0], out2) and torch.equal(again[1], lse2)
            ok = ok and p1_ok and p1_lse <= LSE_REL_TOL and p1_same
            line += (f"; P1 o max_abs_err {max_abs(out2, ref2):.3e}, lse rel_err "
                     f"{p1_lse:.3e}, repeat " + ("bit-equal" if p1_same else "DIFFERS"))
            del out2, lse2, ref2, ref2_lse
        tol = GRAD_REL_TOL[dtype_name]
        for label, cot in (("dlse", dlse), ("no dlse", None)):
            got = fb.blockwise_attention_bwd(q, k, v, out, lse, do, scale, cot)
            again = fb.blockwise_attention_bwd(q, k, v, out, lse, do, scale, cot)
            torch.cuda.synchronize()
            want = fb.blockwise_attention_bwd_reference(q, k, v, out, lse, do, scale, cot)
            rel = b2_grad_errs(q, k, v, do, scale, got, want)
            same = all(torch.equal(a, g) for a, g in zip(again, got))
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            ok = ok and same and finite and max(rel) <= tol
            line += (f"; {label} dq/dk/dv rel_err " + "/".join(f"{e:.3e}" for e in rel)
                     + f" (<= {tol:g} of max|ref|, floored), repeat "
                     + ("bit-equal" if same else "DIFFERS"))
        abs_errs = [max_abs(g, w) for g, w in zip(got, want)]
        print(line + f" {'ok' if ok else 'MISS'}", flush=True)
        if not ok:
            fail(f"B2 kernels disagree at ({b},{h},{n},{d}) {dtype_name}")
        errors[(b, h, n, d, dtype_name)] = {
            "fwd": max_abs(out, ref), "lse": max_abs(lse, ref_lse),
            "dq": abs_errs[0], "dkv": max(abs_errs[1:])}
        del q, k, v, do, out, lse, ref, ref_lse, got, again, want
    blockwise_head_isolation(torch, fb)
    return errors


def blockwise_head_isolation(torch, fb):
    """With a NaN planted in head 1's K, heads 0 and 2 of B2's and P1's
    bf16 forwards stay finite and equal the plain version of each head
    alone (by :func:`forward_ok`, lse within LSE_REL_TOL): no tile reads
    another head's rows."""
    b, h, n, d = 2, 3, 1025, 64
    q, k, v = heads_qkv(b, h, n, d, torch.bfloat16, seed=870)
    k[:, 1, n // 2, 3] = float("nan")
    for forward, plain in ((fb.blockwise_attention_fwd, fb.blockwise_attention_reference),
                           (fb.blockwise_attention_fwd_exp2,
                            fb.blockwise_attention_exp2_reference)):
        out, lse = forward(q, k, v, 0.125)
        torch.cuda.synchronize()
        errs = []
        ok = not bool(torch.isfinite(out[:, 1]).all())  # the NaN spreads in its head
        for head in (0, 2):
            alone = [x[:, head:head + 1].contiguous() for x in (q, k, v)]
            ref, ref_lse = plain(*alone, 0.125, fb.KERNEL_BLOCK_K)
            head_ok, _ = forward_ok(torch, out[:, head:head + 1], ref, "bfloat16")
            lse_err = rel_err(lse[:, head:head + 1], ref_lse)
            ok = ok and head_ok and lse_err <= LSE_REL_TOL
            errs.append(f"{max_abs(out[:, head:head + 1], ref):.3e} / {lse_err:.3e}")
        print(f"  head isolation ({b},{h},{n},{d}) bfloat16, NaN in head 1's K, "
              f"{forward.__name__}: heads 0 and 2 o max_abs_err / lse rel_err "
              f"{'; '.join(errs)} against each head alone {'ok' if ok else 'MISS'}",
              flush=True)
        if not ok:
            fail(f"{forward.__name__} reads across heads")
    for where in ("k", "do"):
        blockwise_bwd_head_isolation(torch, fb, where)


def blockwise_bwd_head_isolation(torch, fb, where):
    """With a NaN planted in head 1's K (its o and lse NaN too) or, apart,
    in head 1's dO, heads 0 and 2 of B2's bf16 backward (with an lse
    cotangent) give dq, dk and dv that are finite and within GRAD_REL_TOL
    (floored, B2_GRAD_FLOOR) of the plain version of each head alone: no
    tile, statistic or delta is read from another head."""
    b, h, n, d = 2, 3, 1025, 64
    q, k, v, do = heads_qkv(b, h, n, d, torch.bfloat16, seed=875, count=4)
    dlse = torch.randn(b, h, n, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(876))
    {"k": k, "do": do}[where][:, 1, n // 2, 3] = float("nan")
    out, lse = fb.blockwise_attention_fwd(q, k, v, 0.125)
    got = fb.blockwise_attention_bwd(q, k, v, out, lse, do, 0.125, dlse)
    torch.cuda.synchronize()
    ok = not bool(torch.isfinite(got[0][:, 1]).all())  # the NaN spreads in its head
    errs = []
    for head in (0, 2):
        alone = [x[:, head:head + 1].contiguous() for x in (q, k, v, out, lse, do)]
        want = fb.blockwise_attention_bwd_reference(*alone, 0.125,
                                                    dlse[:, head:head + 1].contiguous())
        mine = [g[:, head:head + 1] for g in got]
        rel = b2_grad_errs(*alone[:3], alone[5], 0.125, mine, want)
        ok = ok and all(bool(torch.isfinite(g).all()) for g in mine)
        ok = ok and max(rel) <= GRAD_REL_TOL["bfloat16"]
        errs.append("/".join(f"{e:.3e}" for e in rel))
    print(f"  backward head isolation ({b},{h},{n},{d}) bfloat16, NaN in head 1's "
          f"{'K' if where == 'k' else 'dO'}: heads 0 and 2 dq/dk/dv rel_err "
          f"{'; '.join(errs)} against each head alone {'ok' if ok else 'MISS'}", flush=True)
    if not ok:
        fail("blockwise_attention_bwd reads across heads")


def phase_mlp_kernels(torch, fm):
    """Kernel B4 against its plain versions: per token count, width and
    dtype, the forward without a mask (serving), with the keep-mask (the
    teacher), with the mask and pre saved (the student; its output must
    equal the masked forward's bit for bit), and the backward with and
    without the mask (from the plain forward's pre). Returns, per (T,
    d_model, d_ff, dtype), the max abs errors of each entry point."""
    print("== kernels: fused_mlp_fwd, fused_mlp_fwd_pre and fused_mlp_bwd "
          "against fused_mlp_reference and fused_mlp_bwd_reference", flush=True)
    cases = [(t, *MLP_DIMS) for t in MLP_ROWS] + MLP_WIDE_CASES
    errors = {}
    for dtype_name in ("bfloat16", "float32"):
        tol = MLP_REL_TOL[dtype_name]
        for idx, (t, d, d_ff) in enumerate(cases):
            x, w1, b1, w2, b2, mask, do = mlp_inputs(
                torch, t, getattr(torch, dtype_name), seed=400 + idx, dims=(d, d_ff))
            plain = fm.fused_mlp_reference(x, w1, b1, w2, b2)
            want, want_pre = fm.fused_mlp_reference(x, w1, b1, w2, b2, mask,
                                                    KEEP_PROB, save_pre=True)
            out = fm.fused_mlp_fwd(x, w1, b1, w2, b2)
            out_mask = fm.fused_mlp_fwd(x, w1, b1, w2, b2, mask, KEEP_PROB)
            out_pre, pre = fm.fused_mlp_fwd(x, w1, b1, w2, b2, mask, KEEP_PROB,
                                            save_pre=True)
            rel = {"fwd": rel_err(out, plain), "fwd mask": rel_err(out_mask, want),
                   "pre": rel_err(pre, want_pre)}
            outs = [out, out_mask, out_pre]
            for m, label in ((mask, "bwd mask"), (None, "bwd")):
                got = fm.fused_mlp_bwd(x, want_pre, do, w1, w2, m, KEEP_PROB)
                ref = fm.fused_mlp_bwd_reference(x, want_pre, do, w1, w2, m, KEEP_PROB)
                for name, g, r in zip(MLP_GRADS, got, ref):
                    rel[f"{label} {name}"] = rel_err(g, r)
                outs.extend(got)
                if m is not None:
                    bwd_abs = {name: max_abs(g, r)
                               for name, g, r in zip(MLP_GRADS, got, ref)}
            torch.cuda.synchronize()
            same = torch.equal(out_pre, out_mask)
            finite = all(bool(torch.isfinite(o).all()) for o in outs)
            ok = same and finite and max(rel.values()) <= tol
            print(f"  T={t} {d}->{d_ff} {dtype_name}: rel_err " + ", ".join(
                f"{k} {v:.3e}" for k, v in rel.items())
                + f" (each <= {tol:g} of its max|ref|); fwd_pre output "
                f"{'bit-equal to' if same else 'DIFFERS from'} fwd's "
                f"{'ok' if ok else 'MISS'}", flush=True)
            if not ok:
                fail(f"fused MLP kernels disagree at T={t} d_model {d} {dtype_name}")
            errors[(t, d, d_ff, dtype_name)] = {
                "fwd": max_abs(out, plain), "fwd_pre": max_abs(out_pre, want),
                "bwd_abs": bwd_abs,
                "bwd_rel": {name: rel[f"bwd mask {name}"] for name in MLP_GRADS}}
    return errors


# Kernel P2 (dropout-masked second FFN product), (T, d_ff, d_out): the DINO
# student-globals FFN (the probe's shape), a ragged T, T = 1, and ViT-B/16's
# FFN at 384 px
MASKED_CASES = [(37120, 1536, 384), (5365, 1536, 384), (1, 1536, 384),
                (36928, 3072, 768)]
MASKED_GRADS = ("dh", "dw2", "db2")  # masked_matmul_bwd's outputs


def masked_inputs(torch, t, d_ff, d_out, dtype, seed):
    """h (GELU-like, >= -0.17), a dropout16 keep-mask at rate 0.1, w2 and b2
    nn.Linear-initialised in the nn.Linear layout, and an upstream
    gradient."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.nn.functional.gelu(torch.randn(t, d_ff, generator=g, device="cuda")).to(dtype)
    mask = torch.randint(0, 65536, (t, d_ff), generator=g, device="cuda") >= 6554
    bound = d_ff ** -0.5
    w2 = ((torch.rand(d_out, d_ff, generator=g, device="cuda") * 2 - 1) * bound).to(dtype)
    b2 = ((torch.rand(d_out, generator=g, device="cuda") * 2 - 1) * bound).to(dtype)
    do = torch.randn(t, d_out, generator=g, device="cuda").to(dtype)
    return h, mask, w2, b2, do


def phase_masked_kernels(torch, mm):
    """Kernel P2 against its plain versions, per case and dtype: the
    forward, and the backward (dh, dw2, db2; a second call must repeat it
    bit for bit: no atomics). In bf16 a profile of each entry must name its
    Hopper kernels (``P2_BODIES``; the backward also ``P2_REDUCTION``) and
    no other. Returns, per (T, d_ff, dtype), the max abs errors."""
    print("== kernels: masked_mm_fwd and masked_mm_bwd against "
          "masked_matmul_reference and masked_matmul_bwd_reference", flush=True)
    errors = {}
    for dtype_name in ("bfloat16", "float32"):
        tol = MLP_REL_TOL[dtype_name]
        for idx, (t, d_ff, d_out) in enumerate(MASKED_CASES):
            h, mask, w2, b2, do = masked_inputs(torch, t, d_ff, d_out,
                                                getattr(torch, dtype_name), seed=600 + idx)
            out = mm.masked_matmul_fwd(h, mask, w2, b2, KEEP_PROB)
            want = mm.masked_matmul_reference(h, mask, w2, b2, KEEP_PROB)
            got = mm.masked_matmul_bwd(h, mask, do, w2, KEEP_PROB)
            ref = mm.masked_matmul_bwd_reference(h, mask, do, w2, KEEP_PROB)
            again = mm.masked_matmul_bwd(h, mask, do, w2, KEEP_PROB)
            torch.cuda.synchronize()
            rel = {"fwd": rel_err(out, want)}
            rel.update({name: rel_err(g, r) for name, g, r in zip(MASKED_GRADS, got, ref)})
            repeat = all(torch.equal(a, b) for a, b in zip(again, got))
            finite = all(bool(torch.isfinite(o).all()) for o in (out, *got))
            shapes = out.shape == want.shape and all(
                g.shape == r.shape and g.dtype == r.dtype for g, r in zip(got, ref))
            ok = repeat and finite and shapes and max(rel.values()) <= tol
            print(f"  T={t} {d_ff}->{d_out} {dtype_name}: rel_err " + ", ".join(
                f"{k} {v:.3e}" for k, v in rel.items())
                + f" (each <= {tol:g} of its max|ref|); backward "
                f"{'repeats' if repeat else 'DOES NOT repeat'} bit for bit "
                f"{'ok' if ok else 'MISS'}", flush=True)
            if not ok:
                fail(f"masked matmul kernels disagree at T={t} {d_ff}->{d_out} {dtype_name}")
            if dtype_name == "bfloat16":
                calls = {mm.KERNEL: lambda: mm.masked_matmul_fwd(h, mask, w2, b2, KEEP_PROB),
                         mm.KERNEL_BWD: lambda: mm.masked_matmul_bwd(h, mask, do, w2,
                                                                     KEEP_PROB)}
                for entry, call in calls.items():
                    bodies = P2_BODIES[entry]
                    extra = (P2_REDUCTION,) if entry == mm.KERNEL_BWD else ()
                    # three calls a window: a session that loses some of
                    # its device events still names the kernels
                    profile_window(torch, lambda: [call() for _ in range(3)],
                                   f"3 {entry} calls at T={t} {d_ff}->{d_out}", rows=4,
                                   want=bodies, absent=P2_MMA_SYNC_BODIES,
                                   only=bodies + extra)
            errors[(t, d_ff, dtype_name)] = {
                "fwd": max_abs(out, want),
                "bwd_abs": {name: max_abs(g, r) for name, g, r in zip(MASKED_GRADS, got, ref)},
                "bwd_rel": {name: rel[name] for name in MASKED_GRADS}}
    return errors


ATTENTION_CALLS = ("attention_nhd", "fused_attention", "blockwise_attention")


@contextlib.contextmanager
def routed_attention(nhd, fused, blockwise):
    """Route the model's attention (B1's, B3's and B2's calls) through
    ``nhd``, ``fused`` and ``blockwise``."""
    from vit_ssl_tpu_torch.ops import attention as attention_mod

    kernels = [getattr(attention_mod, name) for name in ATTENTION_CALLS]
    for name, fn in zip(ATTENTION_CALLS, (nhd, fused, blockwise)):
        setattr(attention_mod, name, fn)
    try:
        yield
    finally:
        for name, fn in zip(ATTENTION_CALLS, kernels):
            setattr(attention_mod, name, fn)


def plain_attention():
    """Route the model's attention through the plain PyTorch versions,
    forward and backward."""
    from vit_ssl_tpu_torch.ops.flash_attention import (
        attention_nhd_plain, fused_attention_plain)
    from vit_ssl_tpu_torch.ops.flash_blockwise import blockwise_attention_plain

    return routed_attention(attention_nhd_plain, fused_attention_plain,
                            blockwise_attention_plain)


@contextlib.contextmanager
def no_plain_attention(fa):
    """Make any call of a plain attention version (B1, B3, B2) fail: the
    main path must run the kernels only."""
    from vit_ssl_tpu_torch.ops import flash_blockwise as fb

    names = {fa: ("attention_nhd_reference", "attention_nhd_stats_reference",
                  "attention_nhd_bwd_reference", "fused_attention_reference",
                  "fused_attention_stats_reference", "fused_attention_bwd_reference"),
             fb: ("blockwise_attention_reference", "blockwise_attention_exp2_reference",
                  "blockwise_attention_bwd_reference",
                  "blockwise_attention_delta_reference", "_bwd_plain")}
    saved = [(module, name, getattr(module, name))
             for module, module_names in names.items() for name in module_names]

    def refuse(*args, **kwargs):
        raise AssertionError("a plain attention version ran on the main path")

    for module, name, _ in saved:
        setattr(module, name, refuse)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


@contextlib.contextmanager
def refused(module, names, what):
    """Make any call of ``module``'s ``names`` fail: the main path must run
    the kernels only."""
    saved = {name: getattr(module, name) for name in names}

    def refuse(*args, **kwargs):
        raise AssertionError(f"a plain {what} version ran on the main path")

    for name in names:
        setattr(module, name, refuse)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def no_plain_mlp(fm):
    """Make any call of a plain fused-MLP version fail."""
    return refused(fm, ("fused_mlp_reference", "fused_mlp_bwd_reference"), "fused-MLP")


def no_plain_masked(mm):
    """Make any call of a plain masked-matmul (P2) version fail."""
    return refused(mm, ("masked_matmul_reference", "masked_matmul_bwd_reference"),
                   "masked-matmul")


@contextlib.contextmanager
def ffn_unfused(*nets):
    """Run every FFN of ``nets`` as the unfused chain (the same parameters),
    then switch them back to kernel B4."""
    set_fused(nets, False)
    try:
        yield
    finally:
        set_fused(nets, True)


def fused_config():
    """DINO ViT-S/8 with ``model.use_fused_mlp=true``."""
    cfg = copy.deepcopy(DINO_VIT_S8)
    cfg["model"]["use_fused_mlp"] = True
    return cfg


def write_checkpoint(torch, cfg, path):
    """A ``.pth`` as ``scripts/export_torch.py`` writes it: teacher and
    student backbones (seeds 0 and 1, so every call gives the same weights)
    and the config."""
    from vit_ssl_tpu_torch.models import build_backbone

    teacher = build_backbone(cfg, "cpu").reset_parameters(
        torch.Generator().manual_seed(0))
    student = build_backbone(cfg, "cpu").reset_parameters(
        torch.Generator().manual_seed(1))
    state = {f"teacher_backbone.{k}": v for k, v in teacher.state_dict().items()}
    state.update({f"student_backbone.{k}": v
                  for k, v in student.state_dict().items()})
    torch.save({"model_state_dict": state, "config": cfg, "epoch": 0}, path)
    return teacher


def warm_batch_ms(server, x) -> float:
    """Median host-clock ms of 10 ``forward_batch`` calls (host copies
    included)."""
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        server.forward_batch(x)
        host.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(host))


def row_cosine(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def phase_serving(torch, fa, tmp):
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.serve import Server

    print("== serving: DINO ViT-S/8, batch 128, img 96 (N=145), bf16", flush=True)
    pth = f"{tmp}/dino_vit_s8.pth"
    teacher = write_checkpoint(torch, DINO_VIT_S8, pth)

    server = Server(pth, batch_size=SERVE_BATCH, device="cuda")
    img = DINO_VIT_S8["data"]["img_size"]
    x = np.random.default_rng(0).random((SERVE_BATCH, img, img, 3), np.float32)

    with no_plain_attention(fa):
        kernels.launches.clear()  # the serving path's run starts here
        out = server.forward_batch(x)
        per_forward = kernels.launches[fa.KERNEL]
        short = server.forward_batch(x[:37])
        main_launches = dict(kernels.launches)  # ... and ends here
    blocks = DINO_VIT_S8["model"]["num_blocks"]
    print(f"  launches: {main_launches} ({per_forward} in the first forward)",
          flush=True)
    if per_forward != blocks or main_launches != {fa.KERNEL: 2 * blocks}:
        fail(f"expected {blocks} attention_nhd_fwd launches per forward and "
             f"nothing else, got {per_forward} then {main_launches}")

    embed = DINO_VIT_S8["model"]["embed_dim"]
    if out.shape != (SERVE_BATCH, embed) or not np.isfinite(out).all():
        fail(f"embeddings {out.shape} not finite ({SERVE_BATCH}, {embed})")
    pad_err = float(np.abs(short - out[:37]).max())
    print(f"  padding: short batch of 37 vs full batch rows, max_abs_diff "
          f"{pad_err:.3e} (must be 0)", flush=True)
    if pad_err != 0.0:
        fail("zero-padding rows changed real rows")

    ref_model = teacher.to("cuda").eval()
    with plain_attention(), torch.inference_mode():
        ref = ref_model(torch.from_numpy(x).cuda()).float().cpu().numpy()
    if dict(kernels.launches) != main_launches:
        fail("the plain-attention reference run launched a kernel")
    cos = row_cosine(out, ref)
    max_err = float(np.abs(out - ref).max())
    limit = 2e-2 * float(np.abs(ref).max())
    print(f"  against plain attention on the card: min row cosine "
          f"{cos.min():.6f} (>= 0.999), max_abs_err {max_err:.3e} "
          f"(<= {limit:.3e})", flush=True)
    if cos.min() < 0.999 or max_err > limit:
        fail("serving embeddings disagree with the plain attention path")
    return server, x, out, main_launches


def phase_serving_fused(torch, fa, fm, tmp, x, unfused_out, card):
    """The serving path with ``model.use_fused_mlp=true`` on the weights of
    :func:`phase_serving`: 6 B4 and 6 B1 forwards a batch, and embeddings
    within row cosine 0.999 of the unfused server's."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.serve import Server

    print("== fused serving: DINO ViT-S/8 with model.use_fused_mlp=true, batch "
          f"{SERVE_BATCH}, bf16", flush=True)
    pth = f"{tmp}/dino_vit_s8_fused.pth"
    write_checkpoint(torch, fused_config(), pth)
    server = Server(pth, batch_size=SERVE_BATCH, device="cuda")
    with no_plain_attention(fa), no_plain_mlp(fm):
        kernels.launches.clear()  # the fused serving path's run starts here
        out = server.forward_batch(x)
        main_launches = dict(kernels.launches)  # ... and ends here
    blocks = DINO_VIT_S8["model"]["num_blocks"]
    want = {fa.KERNEL: blocks, fm.KERNEL: blocks}
    print(f"  launches: {main_launches} (expected {want})", flush=True)
    if main_launches != want:
        fail(f"a fused served batch launched {main_launches}, expected {want}")
    cos = row_cosine(out, unfused_out)
    max_err = float(np.abs(out - unfused_out).max())
    print(f"  against the unfused server on the same weights: min row cosine "
          f"{cos.min():.6f} (>= 0.999), max_abs_diff {max_err:.3e}", flush=True)
    if not np.isfinite(out).all() or cos.min() < 0.999:
        fail("fused serving embeddings disagree with the unfused server")
    warm_ms = warm_batch_ms(server, x)
    print(f"  fused serving on {card}: warm batch {warm_ms:.3f} ms median of 10 "
          f"({SERVE_BATCH / warm_ms * 1e3:.1f} img/s), host clock incl. H2D/D2H",
          flush=True)
    return main_launches


# profiler sessions a window may take, and the spin kernel's milliseconds on
# each side of the window in the first session, doubled after each session
# that lost events (see profile_window)
PROFILE_SESSIONS = 5
PROFILE_PAD_MS = 2.0
# the name of torch.cuda._sleep's kernel, which pads a window
PAD_KERNEL = "spin_kernel"


def profile_window(torch, fn, label, rows=14, want=(), counts=None, absent=(), only=(),
                   report=None):
    """Device busy and idle share of ``fn`` under ``torch.profiler``, and
    the top device operations. ``fn`` runs twice a session: a warm-up cycle
    of the profiler, not recorded, then the recorded one. Kineto keeps a
    device activity only inside the recorded cycle's window on the host
    clock, and the card's timestamps sit off that clock by up to a few
    hundred microseconds (``vit_ssl_tpu_torch/scripts/profiler_window_probe.py``),
    so a short window could lose its edge kernels or all of them. The
    recorded cycle therefore holds a spin kernel (``torch.cuda._sleep``) of
    ``PROFILE_PAD_MS`` before ``fn`` and one after; the spins are left out
    of every name, count and time below. Sessions repeat, up to
    PROFILE_SESSIONS, with the pads doubled each time, until one records
    some device operation of ``fn``, every name in ``want`` (a name or a
    tuple of names) and, for each name of ``counts``, that many launches of
    kernels whose names hold it; that session is the one reported. Fails if
    none does, if a session records a kernel whose name holds one of
    ``absent``, or (with ``only``) one whose name holds none of ``only``.
    With ``report`` (a dict), the reported session's launches of each
    device operation go into ``report["device_counts"]``. Returns (idle
    share, device busy ms)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from vit_ssl_tpu_torch.scripts.profiler_window_probe import spin_cycles_per_ms

    wants = (want,) if isinstance(want, str) else tuple(want)
    counts = counts or {}
    cycles_per_ms = spin_cycles_per_ms()
    pad_cycles = int(PROFILE_PAD_MS * cycles_per_ms)
    for session in range(1, PROFILE_SESSIONS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            torch.cuda._sleep(pad_cycles)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda._sleep(pad_cycles)
            torch.cuda.synchronize()
            prof.step()
        events = prof.key_averages()
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep") and PAD_KERNEL not in e.key]
        device_names = [e.key for e in device]
        missing = [name for name in wants
                   if not any(name in key for key in device_names)]
        launched = {name: sum(e.count for e in device if name in e.key) for name in counts}
        missing += [f"{name} x{count} (got {launched[name]})"
                    for name, count in counts.items() if launched[name] != count]
        stray = [key for key in device_names if any(name in key for name in absent)
                 or only and not any(name in key for name in only)]
        if stray:
            fail(f"the profile of {label} names {stray}")
        if device_names and not missing:
            break
        print(f"  profile of {label}: session {session} (pads of "
              f"{pad_cycles / cycles_per_ms:.1f} ms) recorded "
              f"{len(device_names)} device operations"
              + (f", none named {missing}" if missing else ""), flush=True)
        pad_cycles *= 2
    else:
        fail(f"{PROFILE_SESSIONS} profiles of {label} recorded no device operation"
             + (f" named {missing}" if wants or counts else ""))
    # device-side entries of fn only (kernels, copies); CPU ops repeat their
    # time, and so does the schedule's ProfilerStep range on the device
    device_us = sum(e.self_device_time_total for e in device)
    if report is not None:
        report["device_counts"] = {e.key: e.count for e in device}
    idle = 1 - device_us / 1e3 / wall_ms
    print(f"  profile of {label}: wall {wall_ms:.3f} ms, device busy "
          f"{device_us / 1e3:.3f} ms, device idle share {idle:.3f}"
          + (f" (session {session})" if session > 1 else ""), flush=True)
    # one row more for the pads' spin kernel
    print(events.table(sort_by="self_device_time_total", row_limit=rows + 1,
                       max_name_column_width=70), flush=True)
    return idle, device_us / 1e3


def phase_serving_times(torch, fa, server, x, card):
    print(f"== serving times on {card}", flush=True)
    warm_ms = warm_batch_ms(server, x)
    print(f"  serving: warm batch {warm_ms:.3f} ms median of 10 "
          f"({SERVE_BATCH / warm_ms * 1e3:.1f} img/s), host clock incl. "
          f"H2D/D2H; start-up warm batch {server.warm_s * 1e3:.3f} ms",
          flush=True)

    b, n, h, d, dtype_name, bs = ATTENTION_CASES[0]
    xq, xk, xv = qkv(b, n, h, d, getattr(torch, dtype_name), seed=100)
    scale = 1.0 / d ** 0.5
    row = b1_forward_row(torch, fa, fa.KERNEL, "", xq, xk, xv, h, scale, bs,
                         attention_bound(b, n, h, d, dtype_name, bs))
    f32 = [t.float() for t in (xq, xk, xv)]
    f32_ms = cuda_ms(lambda: fa.attention_nhd_fwd(*f32, h, scale, bs))
    f32_bound_ms, f32_bound_by = attention_bound(b, n, h, d, "float32", bs)
    print(f"  attention_nhd_fwd ({b},{n},{h}x{d}) float32 (CUDA cores): kernel "
          f"{f32_ms:.4f} ms, bound {f32_bound_ms:.4f} ms ({f32_bound_by})",
          flush=True)

    def five_batches():
        for _ in range(5):
            server.forward_batch(x)

    profile_window(torch, five_batches, "5 serving batches",
                   want=fa.FORWARD_BODIES[fa.attention_nhd_form(n)])
    return row


def build_training(torch, cfg=DINO_VIT_S8):
    """DINO ViT-S/8's train state on the card (student seeded, teacher its
    copy, center 0), its train_step and a batch of 128 uint8 images."""
    from vit_ssl_tpu_torch.data.device_augment import make_multicrop_fn
    from vit_ssl_tpu_torch.models import build_dino_network
    from vit_ssl_tpu_torch.train import (
        AdamW, TrainState, lr_schedule_from_config, make_dino_steps)

    train, model = cfg["training"], cfg["model"]
    student = build_dino_network(cfg, "cpu").reset_parameters(
        torch.Generator().manual_seed(2)).to("cuda")
    steps_per_epoch = STL10_UNLABELED // train["batch_size"]
    optimizer = AdamW(lr_schedule_from_config(cfg, steps_per_epoch),
                      weight_decay=train["optimizer"]["params"]["weight_decay"])
    state = TrainState(student, optimizer, seed=3)
    view_fn = make_multicrop_fn(cfg["transforms"]["globals"],
                                cfg["transforms"]["locals"],
                                train["num_global_views"], train["num_all_views"])
    train_step, _ = make_dino_steps(
        optimizer, train["num_global_views"], train["num_all_views"],
        student_temp=train["student_temp"],
        center_momentum=model["center_momentum"],
        teacher_dropout=train["teacher_dropout"], view_fn=view_fn,
        pack_locals=model["dino_pack_locals"])
    img = cfg["data"]["img_size"]
    images = np.random.default_rng(4).integers(
        0, 256, (train["batch_size"], img, img, 3), dtype=np.uint8)
    batch = {"image": torch.from_numpy(images).cuda(),
             "weight": torch.ones(train["batch_size"], device="cuda")}
    return state, train_step, batch


def schedule_values():
    """Epoch 0's teacher temperature and momentum (the trainer's epoch-
    granular schedules)."""
    from vit_ssl_tpu_torch.models.dino import (
        cosine_momentum_schedule, teacher_temp_schedule)

    t = DINO_VIT_S8["training"]
    return (teacher_temp_schedule(0, t["teacher_temp"], t["teacher_temp_final"],
                                  t["num_epochs"], t["teacher_temp_scheduler"]),
            cosine_momentum_schedule(0, t["teacher_momentum_start"],
                                     t["teacher_momentum_final"], t["num_epochs"]))


def train_leg(torch, cfg, per_step, guards):
    """Build the step for ``cfg``, take two warm-up steps, then
    TIMED_STEPS steps under ``guards`` (no plain kernel version may run),
    each launching exactly ``per_step``; losses finite, student, teacher
    and center moved. Returns (state, train_step, batch, launches, warm
    step ms)."""
    from vit_ssl_tpu_torch import kernels

    state, train_step, batch = build_training(torch, cfg)
    teacher_temp, teacher_momentum = schedule_values()
    before = {k: v.detach().clone() for k, v in state.model_state_dict().items()}

    for _ in range(2):  # warm-up steps
        out = train_step(state, batch, teacher_temp, teacher_momentum)
    torch.cuda.synchronize()
    losses, host_ms = [float(out["loss"])], []
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        for guard in guards:
            stack.enter_context(guard)
        kernels.launches.clear()  # the training path's run starts here
        for _ in range(TIMED_STEPS):
            counted = dict(kernels.launches)
            t0 = time.perf_counter()
            out = train_step(state, batch, teacher_temp, teacher_momentum)
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(out["loss"]))
            step_launches = {k: v - counted.get(k, 0)
                             for k, v in kernels.launches.items()}
            if step_launches != per_step:
                fail(f"a training step launched {step_launches}, expected "
                     f"{per_step}")
        main_launches = dict(kernels.launches)  # ... and ends here
    print(f"  launches over {TIMED_STEPS} steps: {main_launches} "
          f"(per step {per_step}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          "(torch.cuda.max_memory_allocated)", flush=True)
    print(f"  losses: {' '.join(f'{x:.6f}' for x in losses)}", flush=True)
    print("  stats of the last step: " + ", ".join(
        f"{k} {float(v):.6g}" for k, v in out["dino_stats"].items()), flush=True)
    if not all(np.isfinite(losses)):
        fail("a training loss is not finite")
    after = state.model_state_dict()
    for prefix in ("student_", "teacher_", "center"):
        moved = [k for k in after if k.startswith(prefix)
                 and not torch.equal(before[k], after[k])]
        print(f"  {prefix.rstrip('_')}: {len(moved)} tensors changed", flush=True)
        if not moved:
            fail(f"training left every {prefix}* tensor unchanged")
    return state, train_step, batch, main_launches, float(np.median(host_ms))


def attention_launches(fa):
    """B1's launches in one DINO ViT-S/8 training step: the student's
    training forwards and backwards (globals, packed locals) and the
    teacher's inference forwards."""
    blocks = DINO_VIT_S8["model"]["num_blocks"]
    return {fa.KERNEL_TRAIN: 2 * blocks, fa.KERNEL: blocks, fa.KERNEL_BWD: 2 * blocks}


def phase_training(torch, fa):
    t = DINO_VIT_S8["training"]
    print(f"== training: DINO ViT-S/8 train_step, batch {t['batch_size']}, "
          f"{t['num_global_views']} globals of 96 px (N=145), "
          f"{t['num_all_views'] - t['num_global_views']} packed locals of 48 px "
          f"(N=148, block 37), dropout 0.1, teacher dropout on, output_dim "
          f"16384, bf16, full depth, device augmentation", flush=True)
    state, train_step, batch, main_launches, warm_ms = train_leg(
        torch, DINO_VIT_S8, attention_launches(fa), [no_plain_attention(fa)])
    agreement(torch, fa, state, train_step, batch)
    return state, train_step, batch, main_launches, warm_ms


class _ExactAttention:
    """Attention in fp64 with its exact gradient (no bf16 rounding of p or
    ds): the yardstick for gradients that bf16 cannot resolve. ``function``
    takes B1's (B, N, H·D) arguments, ``fused`` B3's and B2's (B, H, N, D)
    ones. It saves q, k and v and rebuilds p in its backward: saving the
    fp64 p of ViT-B/16 at 512 px would take 6.5 GB a block."""

    @staticmethod
    def heads(x, h):
        b, n, hd = x.shape
        return x.reshape(b, n, h, hd // h).transpose(1, 2).double()

    @staticmethod
    def apply(torch):
        class Exact(torch.autograd.Function):
            """fp64 attention on head-major tensors, block mask ``bs``."""

            @staticmethod
            def probs(q, k, scale, bs):
                s = torch.matmul(q, k.transpose(-1, -2)) * scale
                if bs:
                    idx = torch.arange(s.shape[-1], device=s.device) // bs
                    s = s.masked_fill(idx[:, None] != idx[None, :], float("-inf"))
                return torch.softmax(s, dim=-1)

            @staticmethod
            def forward(ctx, q, k, v, scale, bs):
                ctx.save_for_backward(q, k, v)
                ctx.scale, ctx.bs = scale, bs
                return torch.matmul(Exact.probs(q, k, scale, bs), v)

            @staticmethod
            def backward(ctx, g):
                q, k, v = ctx.saved_tensors
                p = Exact.probs(q, k, ctx.scale, ctx.bs)
                dp = torch.matmul(g, v.transpose(-1, -2))
                ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * ctx.scale
                return (torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q),
                        torch.matmul(p.transpose(-1, -2), g), None, None)

        return Exact.apply

    @classmethod
    def function(cls, torch):
        exact = cls.apply(torch)

        def nhd(xq, xk, xv, h, scale, bs=0):
            o = exact(*(cls.heads(x, h) for x in (xq, xk, xv)), scale, bs)
            return o.transpose(1, 2).reshape(xq.shape).to(xq.dtype)

        return nhd

    @classmethod
    def fused(cls, torch):
        exact = cls.apply(torch)
        return lambda q, k, v, scale: exact(q.double(), k.double(), v.double(),
                                            scale, 0).to(q.dtype)


def exact_attention(torch):
    """Route the model's attention through :class:`_ExactAttention`."""
    fused = _ExactAttention.fused(torch)
    return routed_attention(_ExactAttention.function(torch), fused, fused)


def judge(torch, ref, got, want, exact_step, got_center=None, want_center=None,
          names=("kernel", "plain")):
    """The bars of a step against a reference step (``ref`` names it) from
    one cloned state and the same generator seeds, so the dropout masks and
    the views are the same: |dloss| <= 1e-2 |loss|, the center (DINO)
    within 1e-2 max|center|, and every parameter's gradient cosine >= 0.99.
    One stated exception to the last: a gradient that bf16 attention cannot
    resolve. The last block's w_query gradient flows only through the CLS
    rows' softmax backward; after a dozen steps from this init it is ~1e-8
    in norm and the plain bf16 path itself is at cosine ~0.95 from fp64
    attention (this script on an H100 80GB HBM3). So a parameter below 0.99
    passes when the step is as close to an fp64 attention step (the output
    of ``exact_step()``, run only then) as the reference step is (cosine
    within 0.01)."""
    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(
            a.flatten().float(), b.flatten().float(), dim=0))

    mine, theirs = names
    loss, ref_loss = float(got["loss"]), float(want["loss"])
    cosines = {name: cos(g, want["grads"][name]) for name, g in got["grads"].items()}
    worst = min(cosines, key=cosines.get)
    center_err, center_tol = 0.0, 0.0
    center = ""
    if got_center is not None:
        center_err = float((got_center - want_center).abs().max())
        center_tol = 1e-2 * float(want_center.abs().max())
        center = f"; center max_abs_err {center_err:.3e} (<= {center_tol:.3e})"
    print(f"  against {ref} on the card: |dloss| {abs(loss - ref_loss):.3e} "
          f"(<= {1e-2 * abs(ref_loss):.3e}, loss {ref_loss:.6f}); min gradient "
          f"cosine {cosines[worst]:.6f} at {worst} (>= 0.99) over {len(cosines)} "
          f"parameters" + center, flush=True)
    missed = []
    low = [n for n, c in cosines.items() if c < 0.99]
    exact = exact_step() if low else None
    for name in low:
        to_exact = cos(got["grads"][name], exact["grads"][name])
        ref_to_exact = cos(want["grads"][name], exact["grads"][name])
        ok = to_exact >= ref_to_exact - 0.01
        print(f"  {name}: cosine {cosines[name]:.6f} to {theirs}; to fp64 attention "
              f"{mine} {to_exact:.6f}, {theirs} {ref_to_exact:.6f} ({mine} >= "
              f"{theirs} - 0.01) {'ok' if ok else 'MISS'}; |grad| "
              f"{float(exact['grads'][name].norm()):.3e}", flush=True)
        if not ok:
            missed.append(name)
    if abs(loss - ref_loss) > 1e-2 * abs(ref_loss) or center_err > center_tol or missed:
        fail(f"the training step disagrees with {ref}")


def agreement(torch, fa, state, train_step, batch):
    """One step through the kernels and one through the plain attention
    (forward and backward), judged by :func:`judge`."""
    from vit_ssl_tpu_torch import kernels

    temps = schedule_values()
    kernel_state, plain_state = copy.deepcopy(state), copy.deepcopy(state)
    exact_state = copy.deepcopy(state)
    got = train_step(kernel_state, batch, *temps, with_grads=True)
    counted = dict(kernels.launches)
    with plain_attention():
        want = train_step(plain_state, batch, *temps, with_grads=True)
    torch.cuda.synchronize()
    if dict(kernels.launches) != counted:
        fail("the plain-attention step launched a kernel")

    def exact_step():
        with exact_attention(torch):
            return train_step(exact_state, batch, *temps, with_grads=True)

    judge(torch, "plain attention", got, want, exact_step, kernel_state.center,
          plain_state.center)


def set_fused(nets, fused: bool):
    """Switch every FFN of ``nets`` between kernel B4 and the unfused chain
    (the parameters are the same)."""
    from vit_ssl_tpu_torch.ops import FeedForwardBlock

    for net in nets:
        for module in net.modules():
            if isinstance(module, FeedForwardBlock):
                module.use_fused = fused


def fused_agreement(torch, state, train_step, batch):
    """One step with the fused FFN and one with the unfused FFN (B1 in
    both), judged by :func:`judge`; the fp64 yardstick is the unfused step
    with fp64 attention."""
    temps = schedule_values()
    fused_state, unfused_state = copy.deepcopy(state), copy.deepcopy(state)
    exact_state = copy.deepcopy(state)
    set_fused((unfused_state.student, unfused_state.teacher), False)
    set_fused((exact_state.student, exact_state.teacher), False)
    got = train_step(fused_state, batch, *temps, with_grads=True)
    want = train_step(unfused_state, batch, *temps, with_grads=True)
    torch.cuda.synchronize()

    def exact_step():
        with exact_attention(torch):
            return train_step(exact_state, batch, *temps, with_grads=True)

    judge(torch, "the unfused FFN", got, want, exact_step, fused_state.center,
          unfused_state.center, names=("fused", "unfused"))


def phase_training_times(torch, fa, state, train_step, batch, warm_ms, card):
    import torch.nn.functional as F

    t = DINO_VIT_S8["training"]
    print(f"== training times on {card}", flush=True)
    print(f"  train_step: warm step {warm_ms:.3f} ms median of {TIMED_STEPS} "
          f"({t['batch_size'] / warm_ms * 1e3:.1f} img/s), host clock with "
          f"torch.cuda.synchronize(), device augmentation included", flush=True)
    teacher_temp, teacher_momentum = schedule_values()

    rows = {}
    for b, n, h, d, dtype_name, bs in TRAIN_CASES[:4:2]:  # globals, locals (bf16)
        xq, xk, xv = qkv(b, n, h, d, getattr(torch, dtype_name), seed=300)
        (do,) = qkv(b, n, h, d, getattr(torch, dtype_name), seed=301)[:1]
        scale = 1.0 / d ** 0.5
        bounds = attention_train_bounds(b, n, h, d, dtype_name, bs)
        rows[("fwd", bs)] = b1_forward_row(torch, fa, fa.KERNEL_TRAIN, "", xq, xk, xv,
                                           h, scale, bs, bounds["fwd"])

        rows[("bwd", bs)] = b1_backward_row(torch, fa, xq, xk, xv, do, h, scale, bs,
                                            bounds["bwd"])

    # the teacher's inference forward at the globals' shape
    b, n, h, d, dtype_name, bs = TRAIN_CASES[0]
    xq, xk, xv = qkv(b, n, h, d, getattr(torch, dtype_name), seed=302)
    scale = 1.0 / d ** 0.5
    rows[("fwd_inference", bs)] = b1_forward_row(
        torch, fa, fa.KERNEL, ", the teacher", xq, xk, xv, h, scale, bs,
        attention_bound(b, n, h, d, dtype_name, bs))

    def three_steps():
        for _ in range(3):
            train_step(state, batch, teacher_temp, teacher_momentum)

    # every B1 backward of the three steps (globals and packed locals, both
    # resident) runs the form's two Hopper kernels
    backward = fa.BACKWARD_BODIES[fa.attention_nhd_bwd_form(TRAIN_CASES[0][1], 0,
                                                            torch.bfloat16)]
    launches = 3 * attention_launches(fa)[fa.KERNEL_BWD]
    profile_window(torch, three_steps, "3 training steps", rows=25,
                   want=(fa.FORWARD_BODIES[fa.attention_nhd_form(TRAIN_CASES[0][1])],
                         *backward),
                   counts={name: launches for name in backward})
    return rows


def b1_backward_row(torch, fa, xq, xk, xv, do, h, scale, bs, bound):
    """B1's bf16 backward at one shape: ``ms`` through the wrapper, back to
    back (twice, around the plain version's), the wrapper's host
    microseconds a call, ``bare_ms`` (the C entry alone) and SDPA's
    backward (:func:`sdpa_backward_ms`), printed beside ``bound`` and the
    mma.sync body's recorded time; returns the row of the kernels line."""
    b, n, hd = xq.shape
    d = hd // h
    dtype_name = str(xq.dtype).removeprefix("torch.")
    _, stats = fa.attention_nhd_fwd_stats(xq, xk, xv, h, scale, bs)
    first = cuda_ms(lambda: fa.attention_nhd_bwd(xq, xk, xv, do, stats, h, scale, bs))
    plain_ms = cuda_ms(lambda: fa.attention_nhd_bwd_reference(xq, xk, xv, do, h, scale, bs))
    bare_ms = cuda_ms(b1_bare(torch, fa, fa.KERNEL_BWD, xq, xk, xv, h, scale, bs,
                              grad=(do, stats)))
    host = host_us(lambda: fa.attention_nhd_bwd(xq, xk, xv, do, stats, h, scale, bs))
    second = cuda_ms(lambda: fa.attention_nhd_bwd(xq, xk, xv, do, stats, h, scale, bs))
    sdpa = sdpa_backward_ms(torch, xq, xk, xv, do, h, scale, bs)
    form = fa.attention_nhd_bwd_form(n, bs, xq.dtype)
    print(f"  attention_nhd_bwd ({b},{n},{h}x{d}) {dtype_name} block_size={bs} ({form}): "
          f"kernel {first:.4f} / {second:.4f} ms through the wrapper, {host:.1f} us a "
          f"call on the host; the C entry alone "
          f"{bare_ms:.4f} ms; the mma.sync body it replaced "
          f"{B1_MMA_SYNC_MS.get(('bwd', b, n, bs), 'not measured')} ms (recorded), plain "
          f"{plain_ms:.4f} ms, SDPA{' (boolean attn_mask)' if bs else ''} "
          f"{sdpa['library_ms']:.4f} ms (its best reading), bound {bound[0]:.4f} ms "
          f"({bound[1]})", flush=True)
    return {"ms": min(first, second), "ms_readings": [first, second],
            "bare_ms": bare_ms, "wrapper_host_us": host, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], **sdpa, "form": form,
            "kernels": list(fa.BACKWARD_BODIES[form]), "shape": [b, n, h, d, bs]}


SDPA_REPEATS = 5  # readings of each way of feeding SDPA's backward, in turns


def sdpa_backward_ms(torch, xq, xk, xv, do, h, scale, bs):
    """SDPA's backward through autograd on views of B1's (B, N, H·D)
    tensors as (B, H, N, D) (at the packed locals with a boolean
    block-diagonal attn_mask, True = attend), fed dO two ways in turns,
    SDPA_REPEATS readings each: as a strided view of B1's layout (as this
    script fed it before), and contiguous in SDPA's own (B, H, N, D) layout.
    Prints every reading and the spread. On an NVIDIA H100 80GB HBM3 the
    readings fell in two modes at DINO's globals (0.27-0.29 ms and
    0.44-0.58 ms) whichever way dO came, so the figure kept is the best:
    returns ``library_ms`` (the least reading of either way) and both ways'
    readings."""
    import torch.nn.functional as F

    b, n, hd = xq.shape
    d = hd // h
    q, k, v = (x.detach().view(b, n, h, d).transpose(1, 2).requires_grad_()
               for x in (xq, xk, xv))
    mask = None
    if bs:
        block = torch.arange(n, device="cuda") // bs
        mask = block[:, None] == block[None, :]
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
    feeds = {"strided": do.view(b, n, h, d).transpose(1, 2),
             "contiguous": do.view(b, n, h, d).transpose(1, 2).contiguous()}
    readings = {way: [] for way in feeds}
    for _ in range(SDPA_REPEATS):
        for way, g in feeds.items():
            readings[way].append(cuda_ms(
                lambda: torch.autograd.grad(o, (q, k, v), g, retain_graph=True)))
    for way, ms in readings.items():
        print(f"    SDPA backward ({b},{n},{h}x{d}) block_size={bs}, dO {way}: "
              + " / ".join(f"{x:.4f}" for x in ms)
              + f" ms, spread {min(ms):.4f}-{max(ms):.4f}", flush=True)
    return {"library_ms": min(min(ms) for ms in readings.values()),
            "library_ms_readings": readings}


def phase_training_fused(torch, fa, fm, unfused_ms, card):
    """The training step with ``model.use_fused_mlp=true``: exact B4 and B1
    launches per step, agreement with the unfused step, warm step beside
    the unfused leg's, a profile of three steps."""
    t = DINO_VIT_S8["training"]
    print(f"== fused training: the same step with model.use_fused_mlp=true "
          f"(kernel B4 in every FFN)", flush=True)
    blocks = DINO_VIT_S8["model"]["num_blocks"]
    # the student's globals and packed locals (pre saved) and their
    # backwards; the teacher's globals (keep-mask, no pre)
    per_step = {**attention_launches(fa), fm.KERNEL_TRAIN: 2 * blocks,
                fm.KERNEL: blocks, fm.KERNEL_BWD: 2 * blocks}
    state, train_step, batch, main_launches, warm_ms = train_leg(
        torch, fused_config(), per_step, [no_plain_attention(fa), no_plain_mlp(fm)])
    fused_agreement(torch, state, train_step, batch)
    print(f"  fused training on {card}: warm step {warm_ms:.3f} ms median of "
          f"{TIMED_STEPS} ({t['batch_size'] / warm_ms * 1e3:.1f} img/s); the "
          f"unfused leg of this run {unfused_ms:.3f} ms "
          f"({t['batch_size'] / unfused_ms * 1e3:.1f} img/s)", flush=True)
    temps = schedule_values()

    def three_steps():
        for _ in range(3):
            train_step(state, batch, *temps)

    profile_window(torch, three_steps, "3 fused training steps", rows=25)
    return main_launches


TRAINER_IMAGES = 1300  # in-memory uint8 96 x 96 x 3 images: 1040 train, 260 val
# the config's own eval.mode (KNN, linear probe, UMAP) after every epoch:
# best_model records epoch 1 or 2, and the standalone evaluation of it is
# held to that epoch's in-training one
TRAINER_OVERRIDES = ["training.num_epochs=2", "eval.interval=1"]


def config_differences(smoke, composed, path="config"):
    """Paths where a value of ``smoke`` differs from the composed config."""
    if isinstance(smoke, dict):
        if not isinstance(composed, dict):
            return [path]
        return [d for key, value in smoke.items()
                for d in (config_differences(value, composed[key], f"{path}.{key}")
                          if key in composed else [f"{path}.{key}"])]
    if isinstance(smoke, list):
        if not isinstance(composed, list) or len(smoke) != len(composed):
            return [path]
        return [d for i, (a, b) in enumerate(zip(smoke, composed))
                for d in config_differences(a, b, f"{path}[{i}]")]
    return [] if smoke == composed else [f"{path}: {smoke!r} != {composed!r}"]


class InMemoryImages:
    """The decoded STL-10 dataset's item interface (one uint8 HWC image an
    index) over images held in memory: the card's machine has no decoder."""

    def __init__(self, images):
        self.images = images

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx, rng=None):
        return self.images[idx]


def counted_steps(fn, log):
    """``fn`` with each call's host start time, B1 launches and output
    appended to ``log``."""
    from vit_ssl_tpu_torch import kernels

    def call(*args, **kwargs):
        before, t0 = dict(kernels.launches), time.perf_counter()
        out = fn(*args, **kwargs)
        log.append((t0, {k: v - before.get(k, 0) for k, v in kernels.launches.items()
                         if v != before.get(k, 0)}, out))
        return out

    return call


def phase_trainer(torch, fa, card, warm_ms, tmp):
    """DINO ViT-S/8 through the port's own trainer: configs/dino.yaml
    composed by the port's config engine, the loaders of its split over
    in-memory images, ``fit(2)`` (18 train and 6 val steps) with the
    config's evaluation (KNN, linear probe, UMAP) of the teacher after each
    epoch over EVAL_IMAGES labeled in-memory images, best and last
    checkpoints, then a fresh trainer resumed from last_model, bit-equal to
    the file, trains and evaluates epoch 3. Returns the launches of both
    runs' training, the phase's numbers, the evaluations' launches,
    loaders and KNN accuracy by epoch, fit(2)'s last_model tree, and what
    the orbax phase takes from this one: the resumed run's final host
    state, last_model's metadata and the function that builds a trainer
    over the same loaders."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.config import compose, to_container, validate_train_config
    from vit_ssl_tpu_torch.data.builder import make_loaders
    from vit_ssl_tpu_torch.models.builder import build_dino_network
    from vit_ssl_tpu_torch.train.__main__ import get_save_path, get_trainer, save_run_config
    from vit_ssl_tpu_torch.train.trainers.base import to_host
    from vit_ssl_tpu_torch.utils.checkpoint import load_checkpoint

    configs = Path(__file__).resolve().parent / "configs"
    run_dir = str(Path(tmp) / "run")
    overrides = TRAINER_OVERRIDES + [f"hydra.run.dir={run_dir}"]
    print(f"== DINO trainer: configs/dino.yaml composed by vit_ssl_tpu_torch.config "
          f"with {' '.join(overrides)}; fit(2) over {TRAINER_IMAGES} in-memory "
          f"images, then a resumed epoch 3; {card}", flush=True)
    plain = to_container(compose(configs, "dino"))
    diffs = config_differences(DINO_VIT_S8, plain)
    config = compose(configs, "dino", overrides)
    validate_train_config(config)
    composed = to_container(config)
    for key in ("training", "model", "data", "transforms"):
        want = dict(plain[key], num_epochs=2) if key == "training" else plain[key]
        if composed[key] != want:
            diffs.append(f"the overrides changed config.{key} beyond num_epochs")
    if diffs:
        fail("the composed configs/dino.yaml differs from DINO_VIT_S8: "
             + "; ".join(diffs))
    print("  composed config: model, training, data and transforms equal "
          "DINO_VIT_S8 (num_epochs 2 by override)", flush=True)

    images = np.random.default_rng(5).integers(
        0, 256, (TRAINER_IMAGES, 96, 96, 3), dtype=np.uint8)
    mode = str(config.training.type)
    evaluation_loaders = eval_loaders(config, config.data.img_size, seed=23)

    def trainer_for(path):
        train_loader, val_loader = make_loaders(config, InMemoryImages(images))
        network = build_dino_network(config, "cuda")
        trainer = get_trainer(mode, network, path, config, train_loader, val_loader,
                              "cuda")
        trainer.eval_loaders = evaluation_loaders
        return trainer, train_loader, val_loader

    save_path = get_save_path(config)
    save_run_config(config, overrides, save_path)
    trainer, train_loader, val_loader = trainer_for(save_path)
    real = (len(train_loader.dataset), len(val_loader.dataset))
    print(f"  loaders: {real[0]} train images in {len(train_loader)} steps, "
          f"{real[1]} val images in {len(val_loader)} steps, batch "
          f"{train_loader.batch_size}, {train_loader.num_workers} workers", flush=True)
    train_log, val_log, epoch_s = [], [], []
    trainer.train_step = counted_steps(trainer.train_step, train_log)
    trainer.eval_step = counted_steps(trainer.eval_step, val_log)
    train_epoch = trainer.train_epoch

    def timed_epoch(epoch):
        t0 = time.perf_counter()
        metrics = train_epoch(epoch)  # ends in the epoch's one host fetch
        epoch_s.append(time.perf_counter() - t0)
        return metrics

    trainer.train_epoch = timed_epoch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    recorder = EvalRecorder(torch)
    with no_plain_attention(fa), recorder.installed():
        kernels.launches.clear()  # the trainer's path starts here
        trainer.fit(2)
        launches = dict(kernels.launches)  # ... and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fit_eval = recorder.launches()  # the extractions', counted as their own path
    launches = {k: v - fit_eval.get(k, 0) for k, v in launches.items()
                if v != fit_eval.get(k, 0)}

    blocks = DINO_VIT_S8["model"]["num_blocks"]
    per_train, per_val = attention_launches(fa), {fa.KERNEL: 3 * blocks}
    if (len(train_log), len(val_log), trainer.state.step) != (18, 6, 18):
        fail(f"fit(2) ran {len(train_log)} train and {len(val_log)} val steps to "
             f"step {trainer.state.step}, expected 18, 6 and 18")
    for kind, log, want in (("train", train_log, per_train), ("val", val_log, per_val)):
        for i, (_, got, _) in enumerate(log):
            if got != want:
                fail(f"{kind} step {i} of the trainer launched {got}, expected {want}")
    history = trainer.history.history
    bad = [k for k, v in history.items() if not all(np.isfinite(v))]
    if bad or len(history.get("train_Loss", [])) != 2:
        fail(f"trainer epoch metrics not finite or missing: {bad or history}")
    print(f"  launches over fit(2): {launches} (per train step {per_train}, per "
          f"val step {per_val})", flush=True)
    for epoch in (1, 2):
        print(f"  epoch {epoch}: " + ", ".join(
            f"{k} {history[k][epoch - 1]:.6g}" for k in sorted(history)), flush=True)

    meta = {}
    for name in ("best_model", "last_model"):
        path = Path(save_path) / name / "metadata.json"
        if not path.exists() or not (Path(save_path) / name / "state.pt").exists():
            fail(f"the trainer wrote no {name}")
        meta[name] = json.loads(path.read_text())
    last = meta["last_model"]
    if (last["epoch"], last["mode"], last["config"]) != (2, "dino", composed):
        fail(f"last_model metadata: epoch {last['epoch']}, mode {last['mode']}, "
             f"config equal {last['config'] == composed}")
    print(f"  best_model: epoch {meta['best_model']['epoch']}, best_val_score "
          f"{meta['best_model']['best_val_score']:.6g}; last_model: epoch 2", flush=True)

    step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(train_log[9:], train_log[10:])]
    stats = {"epoch_s": epoch_s, "images_per_s": [real[0] / t for t in epoch_s],
             "input_wait_share": [st["wait_s"] / st["wall_s"]
                                  for st in trainer.epoch_input_stats],
             "step_ms_median": float(np.median(step_ms)), "warm_step_ms": warm_ms,
             "peak_gb": peak_gb, "saves": list(trainer.save_times)}
    for epoch, (t, rate, wait) in enumerate(zip(epoch_s, stats["images_per_s"],
                                                stats["input_wait_share"]), 1):
        print(f"  epoch {epoch} on {card}: train {t:.3f} s wall for {real[0]} images "
              f"({rate:.1f} img/s), input-wait share {wait:.4f}; its evaluation "
              f"{recorder.evaluations[epoch - 1]['wall_s']:.3f} s wall", flush=True)
    print(f"  in-loop step (epoch 2, median of {len(step_ms)} intervals between step "
          f"starts) {stats['step_ms_median']:.3f} ms; the bare warm step of the "
          f"training phase {warm_ms:.3f} ms; peak memory {peak_gb:.2f} GB "
          "(torch.cuda.max_memory_allocated)", flush=True)
    for save in trainer.save_times:
        print(f"  checkpoint {save['name']} of epoch {save['epoch']}: snapshot "
              f"{save['snapshot_ms']:.1f} ms (0: the epoch's snapshot reused), "
              f"background write {save['write_s']:.3f} s", flush=True)
    saved, _ = load_checkpoint(str(Path(save_path) / "last_model"))
    del trainer

    resumed, _, _ = trainer_for(save_path)
    resumed.resume_from(str(Path(save_path) / "last_model"))
    mismatch = state_mismatch(torch, to_host(resumed.state.state_dict()), saved)
    if mismatch or resumed.start_epoch != 2:
        fail(f"the resumed state differs from last_model at {mismatch} (start epoch "
             f"{resumed.start_epoch})")
    resumed_log = []
    resumed.train_step = counted_steps(resumed.train_step, resumed_log)
    with no_plain_attention(fa), recorder.installed():
        kernels.launches.clear()  # the resumed run starts here
        resumed.fit(1)
        resumed_launches = dict(kernels.launches)  # ... and ends here
    resumed_eval = {k: v - fit_eval.get(k, 0) for k, v in recorder.launches().items()}
    resumed_launches = {k: v - resumed_eval.get(k, 0) for k, v in resumed_launches.items()
                        if v != resumed_eval.get(k, 0)}
    first_loss = float(resumed_log[0][2]["loss"])
    handoff = {"final": to_host(resumed.state.state_dict()), "last_meta": last,
               "trainer_for": trainer_for, "run_dir": save_path}
    if resumed.state.step != 27 or not np.isfinite(first_loss):
        fail(f"the resumed epoch 3 ended at step {resumed.state.step} (expected 27), "
             f"first loss {first_loss}")
    print(f"  resumed from last_model: state bit-equal to the file (step 18, "
          f"student, teacher, center, AdamW count and moments); epoch 3's first "
          f"loss {first_loss:.6f}, ended at step 27; launches {resumed_launches}",
          flush=True)
    blocks = DINO_VIT_S8["model"]["num_blocks"]
    evaluation = {"launches": check_evaluations(torch, fa, recorder, blocks, "DINO"),
                  "loaders": evaluation_loaders,
                  "knn_by_epoch": {int(Path(ev["save_path"]).name.split("_")[1]):
                                   ev["results"]["eval_knn"]["accuracy"]
                                   for ev in recorder.evaluations},
                  "wall_s": [ev["wall_s"] for ev in recorder.evaluations]}
    if sorted(evaluation["knn_by_epoch"]) != [1, 2, 3]:
        fail(f"the DINO trainer evaluated after epochs {sorted(evaluation['knn_by_epoch'])}, "
             "expected 1, 2 and 3")
    del resumed, recorder
    gc.collect()
    return launches, resumed_launches, stats, evaluation, saved, handoff


@contextlib.contextmanager
def narrow_dino_head(hidden):
    """The port's DINO head at ``hidden`` features (the orbax fixtures' DINO
    head; the package's default is 2048)."""
    from vit_ssl_tpu_torch.models import dino as dino_mod

    wide = dino_mod.DINOHead

    class NarrowDINOHead(wide):
        def __init__(self, embed_dim, output_dim, hidden_dim=None, **kwargs):
            super().__init__(embed_dim, output_dim, hidden, **kwargs)

    dino_mod.DINOHead = NarrowDINOHead
    try:
        yield
    finally:
        dino_mod.DINOHead = wide


def fixture_spec():
    """``tests/torch_orbax_fixtures/fixture_spec.py`` as a module: the orbax
    fixtures' widths, overrides, loaders and ``leaf_digests`` (numpy and the
    standard library only)."""
    path = Path(__file__).resolve().parent / "tests" / "torch_orbax_fixtures" / \
        "fixture_spec.py"
    spec = importlib.util.spec_from_file_location("orbax_fixture_spec", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_orbax_resume(torch, fa, card, tmp, straight, handoff, resumed_launches):
    """The JAX package's orbax checkpoints read by the port: the committed
    fixtures to their digests and a step from the DINO one at its width;
    then phase 9a's step-18 last_model as a JAX-layout tree, resumed by a
    fresh trainer that trains epoch 3 bit-equal to phase 9a's resumed run.
    Returns the launches of both trainings by path."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.config import compose
    from vit_ssl_tpu_torch.models.builder import build_dino_network
    from vit_ssl_tpu_torch.train.trainers import DINOTrainer
    from vit_ssl_tpu_torch.train.trainers.base import to_host
    from vit_ssl_tpu_torch.utils import ocdbt, orbax_tree, zstd
    from vit_ssl_tpu_torch.utils.checkpoint import train_state_to_flax

    root = Path(__file__).resolve().parent
    fixtures = root / "tests" / "torch_orbax_fixtures"
    print(f"== orbax resume: the JAX package's checkpoints through the port's own "
          f"reader (no orbax, tensorstore or zstandard here); {card}", flush=True)
    t0 = time.perf_counter()
    built_s = kernels.build_host(zstd.LIBRARY)
    zstd.crc32c(b"")  # loads the library now: a build or load failure stops here
    print(f"  host library {zstd.LIBRARY}: built in {built_s:.1f} s "
          f"({time.perf_counter() - t0:.1f} s with the load)", flush=True)

    # the committed fixtures, leaf by leaf
    fs = fixture_spec()
    digests = json.loads((fixtures / "digests.json").read_text())
    frames = []
    for name, want in sorted(digests.items()):
        tree = orbax_tree.read_tree(str(fixtures / name / "tree"))
        got = fs.leaf_digests(tree)
        if got != want:
            bad = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
            fail(f"orbax fixture {name}: leaves {bad[:5]} differ from digests.json")
        store = ocdbt.open_store(str(fixtures / name / "tree"))
        frames += [store.read(k) for k in store.list() if not k.endswith(".zarray")]
    decoded = sum(len(zstd.decompress(f)) for f in frames)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        for f in frames:
            zstd.decompress(f)
    zstd_s = (time.perf_counter() - t0) / reps
    print(f"  fixtures: {len(digests)} JAX checkpoints ({', '.join(sorted(digests))}), "
          f"every leaf's sha256, shape and dtype as digests.json records them", flush=True)
    print(f"  zstd decoder on {card}'s host: the fixtures' {len(frames)} chunk frames "
          f"(orbax's level 1, {sum(map(len, frames))} bytes -> {decoded} bytes) in "
          f"{zstd_s * 1e3:.3f} ms a pass, {decoded / zstd_s / 1e6:.1f} MB/s decoded "
          f"(mean of {reps} passes, one thread)", flush=True)

    # one step at the fixture's width from the JAX DINO checkpoint
    fixture_dir = fixtures / "dino_step1"
    with narrow_dino_head(fs.HEAD_HIDDEN):
        config = compose(root / "configs", "dino", fs.DINO)
        train, val = fs.loaders("dino")
        train.n = 1  # one train step
        small = DINOTrainer(build_dino_network(config, "cuda"), str(Path(tmp) / "fixture"),
                            config, train, val, "cuda")
        small.resume_from(str(fixture_dir))
        if (small.state.step, small.start_epoch) != (1, 1):
            fail(f"the DINO fixture resumed at step {small.state.step}, epoch "
                 f"{small.start_epoch}; expected 1 and 1")
        shapes = []
        with no_plain_attention(fa), recorded_b1_shapes(shapes):
            kernels.launches.clear()  # the fixture's step starts here
            small.fit(1)
            fixture_launches = dict(kernels.launches)  # ... and ends here
    blocks = int(config.model.num_blocks)
    want = {fa.KERNEL_TRAIN: 2 * blocks, fa.KERNEL: blocks + 3 * blocks,
            fa.KERNEL_BWD: 2 * blocks}
    b, img, local = fs.B, fs.IMG, fs.LOCAL_IMG
    patch, heads = int(config.model.patch_size), int(config.model.num_heads)
    head = f"{heads}x{int(config.model.embed_dim) // heads}"
    n_global, n_local = (img // patch) ** 2 + 1, (local // patch) ** 2 + 1
    want_shapes = {(2 * b, n_global, head), (b, 4 * n_local, head)}
    held = {(cb, cn, f"{ch}x{cd}") for cb, cn, ch, cd, _, _ in ORBAX_FIXTURE_B1_CASES}
    if want_shapes != held or str(config.model.compute_dtype) != "float32":
        fail(f"the DINO fixture's B1 shapes {sorted(want_shapes)} "
             f"({config.model.compute_dtype}) are not ORBAX_FIXTURE_B1_CASES "
             f"{sorted(held)} (fp32), which the kernels phase holds against the plain version")
    loss = small.history.history["train_Loss"]
    if (fixture_launches != want or set(shapes) != want_shapes
            or small.state.step != 2 or not np.all(np.isfinite(loss))):
        fail(f"the step from the DINO fixture launched {fixture_launches} at "
             f"{sorted(set(shapes))} to step {small.state.step}, loss {loss}; expected "
             f"{want} at {sorted(want_shapes)}, step 2, a finite loss")
    print(f"  a port DINO trainer at the fixture's width resumed from dino_step1 "
          f"(step 1) trained step 2: loss {loss[0]:.6f}; B1 launches {fixture_launches} "
          f"at (batch, seq, heads x head dim) {sorted(set(shapes))}, each held against "
          f"plain attention in the kernels phase (ORBAX_FIXTURE_B1_CASES)", flush=True)
    del small

    # full width: phase 9a's last_model as a JAX-layout tree
    run_dir = Path(handoff["run_dir"])
    target = run_dir / "last_model_orbax"
    shutil.rmtree(target, ignore_errors=True)
    target.mkdir()
    t0 = time.perf_counter()
    flax_tree = train_state_to_flax(straight, handoff["last_meta"])
    orbax_tree.write_tree(str(target / "tree"), flax_tree)
    (target / "metadata.json").write_text(json.dumps(handoff["last_meta"], indent=1))
    write_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in _tensors(straight))
    t0 = time.perf_counter()
    orbax_tree.read_tree(str(target / "tree"))
    read_s = time.perf_counter() - t0
    del flax_tree
    print(f"  phase 9a's last_model (step 18, {nbytes / 1e6:.1f} MB of tensors) as a "
          f"JAX-layout orbax tree: written in {write_s:.3f} s ({nbytes / write_s / 1e6:.0f} "
          f"MB/s, train_state_to_flax and write_tree: Raw zstd frames, one OCDBT leaf "
          f"node), read back in {read_s:.3f} s ({nbytes / read_s / 1e6:.0f} MB/s, "
          f"read_tree; the files warm in the page cache) on {card}", flush=True)

    trainer, _, _ = handoff["trainer_for"](str(Path(tmp) / "orbax_run"))
    trainer.eval_interval = 0  # the train state only: phase 9a's evaluations are its own
    t0 = time.perf_counter()
    trainer.resume_from(str(target))
    resume_ms = (time.perf_counter() - t0) * 1e3
    mismatch = state_mismatch(torch, to_host(trainer.state.state_dict()), straight)
    if mismatch or trainer.start_epoch != 2:
        fail(f"the state resumed from the JAX-layout tree differs from last_model at "
             f"{mismatch} (start epoch {trainer.start_epoch})")
    torch.cuda.synchronize()
    with no_plain_attention(fa):
        kernels.launches.clear()  # the resumed run starts here
        t0 = time.perf_counter()
        trainer.fit(1)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        launches = dict(kernels.launches)  # ... and ends here
    mismatch = state_mismatch(torch, to_host(trainer.state.state_dict()), handoff["final"])
    if trainer.state.step != 27 or mismatch or launches != resumed_launches:
        fail(f"epoch 3 resumed from the JAX-layout tree ended at step "
             f"{trainer.state.step} (expected 27), differs from phase 9a's resumed run "
             f"at {mismatch}, launched {launches} (phase 9a: {resumed_launches})")
    print(f"  a fresh trainer resumed from last_model_orbax through resume_from in "
          f"{resume_ms:.1f} ms (read, bridged, loaded; bit-equal to last_model, start "
          f"epoch 2); epoch 3 in {epoch_s:.3f} s wall to step 27, the whole state "
          f"bit-equal to phase 9a's resumed run, B1 launches {launches} as there; "
          f"{card}", flush=True)
    del trainer
    shutil.rmtree(target)
    shutil.rmtree(Path(tmp) / "orbax_run", ignore_errors=True)
    gc.collect()
    return {"orbax_fixture_step": fixture_launches, "orbax_resumed": launches}


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "element_size"):
        yield tree


def phase_standalone_eval(torch, fa, card, run_dir, evaluation):
    """configs/eval_config.yaml (``eval_knn``) on the DINO trainer's run
    directory, as ``python -m vit_ssl_tpu_torch.evaluate`` dispatches it:
    ``validate_eval_config``, then the unsupervised ``run_evaluation``, which
    merges the run's saved config and loads its best_model's teacher
    (``load_model_state``), over the trainer phase's in-memory loaders. Its
    KNN accuracy must equal the in-training evaluation's at the epoch
    best_model records. Returns its launches."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.config import compose, validate_eval_config
    from vit_ssl_tpu_torch.evaluators import unsupervised_evaluator as ue

    configs = Path(__file__).resolve().parent / "configs"
    print(f"== standalone evaluation: configs/eval_config.yaml with "
          f"eval.experiment_path=<the DINO trainer's run>; {card}", flush=True)
    config = validate_eval_config(compose(configs, "eval_config",
                                          [f"eval.experiment_path={run_dir}"]))
    best_epoch = json.loads((Path(run_dir) / "best_model" / "metadata.json")
                            .read_text())["epoch"]
    recorder = EvalRecorder(torch)
    with no_plain_attention(fa), recorder.installed():
        kernels.launches.clear()  # the standalone evaluation starts here
        results = ue.run_evaluation(config, loaders=evaluation["loaders"], device="cuda")
        launches = dict(kernels.launches)  # ... and ends here
    (ev,) = recorder.evaluations
    blocks = DINO_VIT_S8["model"]["num_blocks"]
    batches = sum(ex["batches"] for ex in ev["extract"])
    if launches != {fa.KERNEL: blocks * batches}:
        fail(f"the standalone evaluation launched {launches}, expected {blocks} B1 "
             f"inference forwards in each of {batches} feature batches")
    if sorted(results) != ["eval_knn"] or not (Path(run_dir) / "evaluation_summary.csv").exists():
        fail(f"the standalone evaluation ran {sorted(results)} and wrote "
             f"{sorted(p.name for p in Path(run_dir).iterdir())}")
    got, want = results["eval_knn"]["accuracy"], evaluation["knn_by_epoch"][best_epoch]
    print(f"  best_model (epoch {best_epoch}) loaded by load_model_state; KNN accuracy "
          f"{got:.4f}, the in-training evaluation of epoch {best_epoch} {want:.4f}; wall "
          f"{ev['wall_s']:.3f} s, extraction {ev['extract'][0]['seconds'] + ev['extract'][1]['seconds']:.3f} s, "
          f"KNN {ev['knn'] * 1e3:.3f} ms; launches {launches}", flush=True)
    if got != want:
        fail(f"the standalone KNN accuracy {got} differs from the in-training "
             f"evaluation's {want} at best_model's epoch {best_epoch}")
    return launches


def state_mismatch(torch, got, want, where="state"):
    """The first path where two checkpoint trees differ, bit for bit."""
    if isinstance(want, torch.Tensor):
        same = (isinstance(got, torch.Tensor) and got.dtype == want.dtype
                and got.shape == want.shape and torch.equal(got, want))
        return None if same else where
    if isinstance(want, dict):
        if set(got) != set(want):
            return where
        for key in want:
            found = state_mismatch(torch, got[key], want[key], f"{where}.{key}")
            if found:
                return found
        return None
    if isinstance(want, list):
        if len(got) != len(want):
            return where
        for i, (a, b) in enumerate(zip(got, want)):
            found = state_mismatch(torch, a, b, f"{where}[{i}]")
            if found:
                return found
        return None
    return None if got == want else where


class InMemoryLabeled:
    """A labeled dataset's item interface (a uint8 HWC image and its class)
    over images held in memory: the card's machine has no decoder."""

    def __init__(self, images, labels):
        self.images, self.labels = images, labels

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx, rng=None):
        return self.images[idx], int(self.labels[idx])


def epoch_recorder(trainer, record):
    """Wrap ``trainer.train_epoch`` to time each epoch (host clock; the
    epoch ends in its one host fetch) and call ``record(epoch)`` after
    it; returns the list of epoch seconds."""
    epoch_s = []
    train_epoch = trainer.train_epoch

    def timed(epoch):
        t0 = time.perf_counter()
        metrics = train_epoch(epoch)
        epoch_s.append(time.perf_counter() - t0)
        record(epoch)
        return metrics

    trainer.train_epoch = timed
    return epoch_s


def check_step_launches(logs, want_counts, steps):
    """Every logged step launched exactly its ``want_counts`` entry (by
    kind), and each kind ran its expected number of steps."""
    for kind, log in logs.items():
        if len(log) != steps[kind]:
            fail(f"{len(log)} {kind} steps ran, expected {steps[kind]}")
        for i, (_, got, _) in enumerate(log):
            if got != want_counts[kind]:
                fail(f"{kind} step {i} launched {got}, expected {want_counts[kind]}")


def check_predictions(run_dir, epochs, val_rows, history, name):
    """Each epoch's ``predictions.csv`` (the supervised evaluation of its
    validation) holds every val row, and its accuracy equals the logged
    val Accuracy."""
    import csv

    for epoch in epochs:
        with open(Path(run_dir) / f"epoch_{epoch}" / "predictions.csv") as f:
            rows = list(csv.DictReader(f))
        accuracy = sum(r["label"] == r["prediction"] for r in rows) / max(len(rows), 1)
        if len(rows) != val_rows or accuracy != history["val_Accuracy"][epoch - 1]:
            fail(f"{name} epoch {epoch}: predictions.csv holds {len(rows)} rows (expected "
                 f"{val_rows}) at accuracy {accuracy}, the validation's "
                 f"{history['val_Accuracy'][epoch - 1]}")
    print(f"  {name}: the supervised evaluation wrote predictions.csv for epochs "
          f"{list(epochs)}, {val_rows} val rows each, accuracy equal to the logged val "
          "Accuracy", flush=True)


def finite_history(trainer, epochs):
    history = trainer.history.history
    bad = [k for k, v in history.items() if not all(np.isfinite(v))]
    if bad or len(history.get("train_Loss", [])) != epochs:
        fail(f"trainer epoch metrics not finite or missing: {bad or history}")
    for epoch in range(1, epochs + 1):
        print(f"  epoch {epoch}: " + ", ".join(
            f"{k} {history[k][epoch - 1]:.6g}" for k in sorted(history)), flush=True)


# The evaluators' cells: STL-10's labeled train split (5000 images, 4000
# train and 1000 val rows at the configs' val_split 0.2), held in memory at
# each config's img_size (the card's machine has no image decoder), 10
# classes each with its own mean colour
EVAL_IMAGES = 5000
EVAL_CLASSES = 10
EVAL_REPORTS = ("evaluation_summary.csv", "evaluation_summary.txt",
                "umap_feature_quality_results.csv", "umap_feature_quality_report.txt")
KNN_TIE = 1e-5  # a k-th and (k+1)-th similarity this close is a near tie


class InMemoryEval:
    """A labeled dataset's item interface over in-memory uint8 images,
    through the evaluators' host pipeline (``Resize`` then ``ToTensor``)."""

    def __init__(self, images, labels):
        from vit_ssl_tpu_torch.data.builder import eval_pipeline

        self.images, self.labels = images, labels
        self.pipeline = eval_pipeline(images.shape[1])

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx, rng=None):
        return self.pipeline(self.images[idx]), int(self.labels[idx])


def eval_loaders(config, img, seed):
    """The evaluators' train and val loaders over EVAL_IMAGES seeded images:
    class-coloured noise (each class a mean colour, then uniform noise), so
    that the features a trained or untrained ViT gives separate the
    classes."""
    from vit_ssl_tpu_torch.data.builder import make_loaders

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, EVAL_CLASSES, EVAL_IMAGES)
    colours = rng.integers(0, 128, (EVAL_CLASSES, 3), dtype=np.uint8)
    # uniform noise in [0, 128) from random bytes (a third of integers()' time)
    noise = np.frombuffer(rng.bytes(EVAL_IMAGES * img * img * 3), np.uint8)
    images = (noise >> 1).reshape(EVAL_IMAGES, img, img, 3)
    images += colours[labels][:, None, None, :]
    return make_loaders(config, InMemoryEval(images, labels))


class EvalRecorder:
    """Times the evaluations' parts on the card (host clock around work that
    ends in ``torch.cuda.synchronize()``) and keeps what the checks need:
    each extraction's network, loader, features, batches and kernel
    launches; each KNN, probe (its L-BFGS iterations and projected
    gradient), projection and quality-metric call; each evaluation's wall
    seconds and directory; the warnings of the evaluators' loggers."""

    def __init__(self, torch):
        self.torch = torch
        self.evaluations = []
        self.warnings = []

    def _timed(self, fn, part):
        def call(*args, **kwargs):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.evaluations[-1][part] = time.perf_counter() - t0
            self.evaluations[-1][part + "_out"] = out
            return out
        return call

    def _extract(self, fn):
        from vit_ssl_tpu_torch import kernels

        def call(network, loader, device=None):
            before = dict(kernels.launches)
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            features, labels = fn(network, loader, device)
            seconds = time.perf_counter() - t0
            self.evaluations[-1]["extract"].append({
                "network": network, "loader": loader, "features": features,
                "labels": labels, "batches": len(loader), "seconds": seconds,
                "launches": {k: v - before.get(k, 0) for k, v in kernels.launches.items()
                             if v != before.get(k, 0)}})
            return features, labels
        return call

    def _evaluation(self, fn):
        def call(config, network=None, save_path=None, loaders=None, device=None):
            self.evaluations.append({"extract": [], "save_path": save_path})
            t0 = time.perf_counter()
            out = fn(config, network, save_path, loaders, device)
            self.torch.cuda.synchronize()
            self.evaluations[-1].update(wall_s=time.perf_counter() - t0, results=out)
            return out
        return call

    @contextlib.contextmanager
    def installed(self):
        import logging

        from vit_ssl_tpu_torch.evaluators import embedding_analysis as ea
        from vit_ssl_tpu_torch.evaluators import linear_probe as lp
        from vit_ssl_tpu_torch.evaluators import unsupervised_evaluator as ue

        patches = [(ue, "run_evaluation", self._evaluation),
                   (ue, "extract_features", self._extract),
                   (ue, "run_knn_evaluation", lambda fn: self._timed(fn, "knn")),
                   (ue, "run_linear_evaluation", lambda fn: self._timed(fn, "probe")),
                   (lp, "lbfgs_probe", lambda fn: self._timed(fn, "lbfgs")),
                   (ea, "_project", lambda fn: self._timed(fn, "umap")),
                   (ea, "evaluate_feature_quality", lambda fn: self._timed(fn, "quality"))]
        saved = [(module, name, getattr(module, name)) for module, name, _ in patches]
        for module, name, wrap in patches:
            setattr(module, name, wrap(getattr(module, name)))
        recorder = self

        class Warnings(logging.Handler):
            def emit(self, record):
                recorder.warnings.append(record.getMessage())

        handler = Warnings(level=logging.WARNING)
        log = logging.getLogger("vit_ssl_tpu_torch.evaluators")
        log.addHandler(handler)
        try:
            yield self
        finally:
            log.removeHandler(handler)
            for module, name, fn in saved:
                setattr(module, name, fn)

    def launches(self):
        """Every kernel launch the extractions made."""
        total = {}
        for evaluation in self.evaluations:
            for ex in evaluation["extract"]:
                for k, v in ex["launches"].items():
                    total[k] = total.get(k, 0) + v
        return total


def knn_mismatches_outside_ties(torch, ex_train, ex_val, differ, k):
    """The val rows (of those in ``differ``) whose neighbour sets are not a
    near tie: their k-th and (k+1)-th cosine similarities apart by more
    than KNN_TIE. The same neighbours give the same vote and the same
    first-maximum argmax on either device, so a prediction that differs
    elsewhere is a fault."""
    from vit_ssl_tpu_torch.evaluators.knn import _normalize

    tf = _normalize(torch.from_numpy(ex_train["features"]).double())
    vf = _normalize(torch.from_numpy(ex_val["features"]).double())
    bad = []
    for row in np.nonzero(differ)[0]:
        sims = torch.sort(vf[row] @ tf.T, descending=True).values
        if sims[k - 1] - sims[k] > KNN_TIE:
            bad.append(int(row))
    return bad


def check_evaluations(torch, fa, recorder, blocks, name):
    """Every evaluation's checks: B1's inference forward exactly ``blocks``
    times a feature batch and no other launch; the reports written; each
    skipped figure named. The last evaluation's features against the same
    extraction with plain attention (row cosine >= 0.999), its KNN and
    probe against the CPU's on the same features. Prints each evaluation's
    times. Returns the launches of the extractions."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.evaluators import knn, linear_probe
    from vit_ssl_tpu_torch.evaluators.evaluator_utils import extract_features

    figures = ("umap_visualization.png", "comprehensive_umap_analysis.png")
    skipped = [w for w in recorder.warnings if all(f in w for f in figures)]
    for i, ev in enumerate(recorder.evaluations):
        for ex in ev["extract"]:
            if ex["launches"] != {fa.KERNEL: blocks * ex["batches"]}:
                fail(f"{name} evaluation {i}: extraction over {ex['batches']} batches "
                     f"launched {ex['launches']}, expected {blocks} B1 inference "
                     "forwards a batch")
        out_dir = Path(ev["save_path"])
        missing = [r for r in EVAL_REPORTS if not (out_dir / r).exists()]
        drawn = all((out_dir / f).exists() for f in figures)
        if missing or not (drawn or any(str(out_dir) in w for w in skipped)):
            fail(f"{name} evaluation into {out_dir}: reports missing {missing}, figures "
                 f"neither drawn nor named as skipped ({recorder.warnings})")
        train, val = ev["extract"]
        rows = len(train["features"]) + len(val["features"])
        extract_s = train["seconds"] + val["seconds"]
        res = ev["results"]
        lbfgs = ev["lbfgs_out"][1]
        print(f"  {name} evaluation into {out_dir.name}/ on the card: wall "
              f"{ev['wall_s']:.3f} s; extraction {rows} rows ({len(train['features'])} "
              f"train, {len(val['features'])} val) in {train['batches'] + val['batches']} "
              f"batches, {extract_s:.3f} s ({rows / extract_s:.1f} img/s), B1 "
              f"{fa.KERNEL} {blocks} a batch; KNN {ev['knn'] * 1e3:.3f} ms (accuracy "
              f"{res['eval_knn']['accuracy']:.4f}); probe {ev['probe']:.3f} s "
              f"({lbfgs.nit} L-BFGS-B iterations, projected gradient "
              f"{float(np.max(np.abs(lbfgs.jac))):.3g}; accuracy "
              f"{res['eval_linear']['accuracy']:.4f}); UMAP {ev['umap']:.3f} s; quality "
              f"metrics {ev['quality']:.3f} s ({res['eval_umap']['quality']}, silhouette "
              f"{res['eval_umap']['metrics']['silhouette_features']:.4f})", flush=True)
    if skipped:
        print(f"  figures skipped and named in the log ({len(skipped)}x): "
              f"{skipped[-1]}", flush=True)

    last = recorder.evaluations[-1]
    train, val = last["extract"]
    counted = dict(kernels.launches)
    with plain_attention():
        plain = [extract_features(ex["network"], ex["loader"], "cuda")[0]
                 for ex in (train, val)]
    if dict(kernels.launches) != counted:
        fail(f"{name}: the plain-attention extraction launched a kernel")
    got = np.concatenate([train["features"], val["features"]]).astype(np.float64)
    cos = float(row_cosine(got, np.concatenate(plain).astype(np.float64)).min())
    if cos < 0.999:
        fail(f"{name}: features against plain attention, min row cosine {cos:.6f} < 0.999")
    card_knn = last["knn_out"]
    cpu_knn = knn.run_knn_evaluation(train["features"], train["labels"], val["features"],
                                     val["labels"], EVAL_CLASSES, device="cpu")
    differ = card_knn["predictions"] != cpu_knn["predictions"]
    bad = knn_mismatches_outside_ties(torch, train, val, differ, card_knn["num_neighbors"])
    if bad:
        fail(f"{name}: KNN predictions on the card differ from the CPU's outside near "
             f"ties at val rows {bad[:10]}")
    cpu_preds, _ = linear_probe.lbfgs_probe(train["features"], train["labels"],
                                            val["features"], "cpu")
    agree = float(np.mean(cpu_preds == last["probe_out"]["predictions"]))
    if agree < 0.99:
        fail(f"{name}: the probe's predictions agree with the CPU run's on {agree:.4f} "
             "of the val rows (< 0.99)")
    print(f"  {name} last evaluation: features against plain attention, min row "
          f"cosine {cos:.6f}; KNN on the card vs the CPU on the same features: "
          f"{int(differ.sum())} of {len(differ)} predictions differ, all near ties; "
          f"probe vs the CPU run: {agree:.4f} of the predictions equal", flush=True)
    return recorder.launches()


def phase_finetune(torch, fa, card, pretrained, tmp):
    """configs/finetune.yaml at DINO ViT-S/8's width from phase 9a's DINO
    ``best_model``: every backbone tensor matched, ``fit(2)`` across the
    unfreeze at epoch 2 with B1's launches exact in every step, the frozen
    tensors unchanged bit for bit through epoch 1 and moved after it.
    Returns the path's launches."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.config import compose, to_container, validate_train_config
    from vit_ssl_tpu_torch.data.builder import make_loaders
    from vit_ssl_tpu_torch.models.builder import build_model, freeze_backbone_mask
    from vit_ssl_tpu_torch.train.__main__ import get_trainer

    configs = Path(__file__).resolve().parent / "configs"
    run_dir = str(Path(tmp) / "finetune")
    overrides = FINETUNE_OVERRIDES + [f"training.pretrained_path={pretrained}",
                                      f"hydra.run.dir={run_dir}"]
    print(f"== finetune: configs/finetune.yaml composed by vit_ssl_tpu_torch.config "
          f"with {' '.join(FINETUNE_OVERRIDES)}, from the DINO trainer's best_model; "
          f"fit(2) over {FINETUNE_IMAGES} in-memory labeled images; {card}", flush=True)
    config = compose(configs, "finetune", overrides)
    validate_train_config(config)
    diffs = config_differences(FINETUNE_S8, to_container(config))
    if diffs:
        fail("the composed configs/finetune.yaml differs from FINETUNE_S8: "
             + "; ".join(diffs))
    rng = np.random.default_rng(10)
    img, classes = FINETUNE_S8["data"]["img_size"], FINETUNE_S8["model"]["num_classes"]
    dataset = InMemoryLabeled(
        rng.integers(0, 256, (FINETUNE_IMAGES, img, img, 3), dtype=np.uint8),
        rng.integers(0, classes, FINETUNE_IMAGES))
    train_loader, val_loader = make_loaders(config, dataset)
    trainer = get_trainer("finetune", build_model(config, "cuda"), run_dir, config,
                          train_loader, val_loader, "cuda")
    network = trainer.network
    backbone = [k for k in network.state_dict()
                if k.startswith(("encoder_blocks.", "patch_embedding."))]
    print(f"  check_loaded_model: {trainer.loaded} ({len(backbone)} backbone tensors)",
          flush=True)
    if trainer.loaded != {"matched": len(backbone), "mismatched": 0}:
        fail(f"the finetune ViT matched {trainer.loaded} of {len(backbone)} backbone "
             "tensors of the DINO checkpoint")
    start = {k: v.detach().clone() for k, v in network.state_dict().items()}
    frozen = [k for k, t in freeze_backbone_mask(network).items() if not t]
    seen = []

    def record(epoch):
        sd = network.state_dict()
        seen.append((epoch, trainer.state.step, trainer.state.opt_state.count,
                     sum(not torch.equal(sd[k], start[k]) for k in frozen)))

    epoch_s = epoch_recorder(trainer, record)
    train_log, val_log = [], []
    build_steps = trainer._build_steps

    def counted_build():  # the unfreeze builds the steps anew
        build_steps()
        trainer.train_step = counted_steps(trainer.train_step, train_log)
        trainer.eval_step = counted_steps(trainer.eval_step, val_log)

    trainer._build_steps = counted_build
    counted_build()
    with no_plain_attention(fa):
        kernels.launches.clear()  # the finetune path starts here
        trainer.fit(2)
        launches = dict(kernels.launches)  # ... and ends here
    blocks = FINETUNE_S8["model"]["num_blocks"]
    steps = len(train_loader)
    check_step_launches({"train": train_log, "val": val_log},
                        {"train": {fa.KERNEL_TRAIN: blocks, fa.KERNEL_BWD: blocks},
                         "val": {fa.KERNEL: blocks}},
                        {"train": 2 * steps, "val": 2 * len(val_loader)})
    print(f"  launches over fit(2): {launches}; (epoch, step, optimizer count, frozen "
          f"tensors changed of {len(frozen)}) after each epoch: {seen}", flush=True)
    if seen[0] != (1, steps, steps, 0) or seen[1][:3] != (2, 2 * steps, steps) \
            or not seen[1][3]:
        fail(f"finetune epochs {seen}: expected the {len(frozen)} frozen tensors "
             "unchanged through epoch 1, the optimizer rebuilt at epoch 2 and the "
             "backbone moving after it")
    finite_history(trainer, 2)
    check_predictions(run_dir, (1, 2), len(val_loader.dataset), trainer.history.history,
                      "finetune")
    for epoch, t in enumerate(epoch_s, 1):
        print(f"  epoch {epoch} on {card}: train {t:.3f} s wall for "
              f"{len(train_loader.dataset)} images "
              f"({len(train_loader.dataset) / t:.1f} img/s)", flush=True)
    # the wrapped epoch and step functions hold the trainer in reference
    # cycles: collect them, so that later phases' peak memory starts clean
    del trainer, network, start
    gc.collect()
    return launches


def phase_b1_vit_b_times(torch, fa, card):
    """B1's three entries at ViT-B/16's 224-px shape, bf16: kernel, plain,
    SDPA and bound (the rows of the kernels line)."""
    b, n, h, d, dtype_name, bs = VIT_B_B1_CASE
    print(f"== B1 at ViT-B/16's 224-px shape ({b},{n},{h}x{d}) {dtype_name} on {card}",
          flush=True)
    dtype = getattr(torch, dtype_name)
    xq, xk, xv = qkv(b, n, h, d, dtype, seed=310)
    (do,) = qkv(b, n, h, d, dtype, seed=311)[:1]
    scale = 1.0 / d ** 0.5
    bounds = attention_train_bounds(b, n, h, d, dtype_name, bs)
    return {
        "fwd": b1_forward_row(torch, fa, fa.KERNEL, ", ViT-B/16 eval", xq, xk, xv, h,
                              scale, bs, attention_bound(b, n, h, d, dtype_name, bs)),
        "fwd_stats": b1_forward_row(torch, fa, fa.KERNEL_TRAIN, ", ViT-B/16 training",
                                    xq, xk, xv, h, scale, bs, bounds["fwd"]),
        "bwd": b1_backward_row(torch, fa, xq, xk, xv, do, h, scale, bs, bounds["bwd"]),
    }


def remat_launches(fa, blocks, remat=True):
    """B1's launches in one supervised ViT training step at N <= 256: with
    remat each checkpointed block runs the training forward twice (its
    first forward, non-reentrant, keeps grad mode on; then the recompute in
    the backward)."""
    return {fa.KERNEL_TRAIN: (2 if remat else 1) * blocks, fa.KERNEL_BWD: blocks}


def phase_vit_b_trainer(torch, fa, card, tmp):
    """configs/vit_b_imagenet.yaml as written (remat on, batch 1024,
    224 px) through ``SupervisedTrainer.fit(2)`` and a resumed epoch 3,
    B1's launches exact in every step; peak memory, the in-loop and warm
    steps, img/s; agreement with the plain-attention step from one cloned
    state. Returns the launches of both runs."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.config import compose, to_container, validate_train_config
    from vit_ssl_tpu_torch.data.builder import make_loaders
    from vit_ssl_tpu_torch.models.builder import build_model
    from vit_ssl_tpu_torch.train.__main__ import get_save_path, get_trainer, save_run_config
    from vit_ssl_tpu_torch.train.trainers.base import to_host
    from vit_ssl_tpu_torch.utils.checkpoint import load_checkpoint

    configs = Path(__file__).resolve().parent / "configs"
    run_dir = str(Path(tmp) / "vit_b")
    overrides = VIT_B16_224_OVERRIDES + [f"hydra.run.dir={run_dir}"]
    print(f"== ViT-B/16 trainer: configs/vit_b_imagenet.yaml composed by "
          f"vit_ssl_tpu_torch.config as written (its evaluation every epoch); "
          f"fit(2) over {VIT_B16_224_IMAGES} in-memory images, then a resumed epoch 3; "
          f"{card}", flush=True)
    plain = to_container(compose(configs, "vit_b_imagenet"))
    diffs = config_differences(VIT_B16_224, plain)
    config = compose(configs, "vit_b_imagenet", overrides)
    validate_train_config(config)
    composed = to_container(config)
    for key in ("training", "model", "data", "parallel", "transforms", "metrics"):
        if composed[key] != plain[key]:
            diffs.append(f"the overrides changed config.{key}")
    if diffs:
        fail("the composed configs/vit_b_imagenet.yaml differs from VIT_B16_224: "
             + "; ".join(diffs))
    print("  composed config: training, model, data, parallel (remat on), transforms "
          "and metrics as written, equal to VIT_B16_224", flush=True)

    rng = np.random.default_rng(9)
    img, classes = VIT_B16_224["data"]["img_size"], VIT_B16_224["model"]["num_classes"]
    dataset = InMemoryLabeled(
        rng.integers(0, 256, (VIT_B16_224_IMAGES, img, img, 3), dtype=np.uint8),
        rng.integers(0, classes, VIT_B16_224_IMAGES))

    def trainer_for(path):
        train_loader, val_loader = make_loaders(config, dataset)
        return get_trainer("supervised", build_model(config, "cuda"), path, config,
                           train_loader, val_loader, "cuda"), train_loader, val_loader

    save_path = get_save_path(config)
    save_run_config(config, overrides, save_path)
    trainer, train_loader, val_loader = trainer_for(save_path)
    if not trainer.network.remat:
        fail("the composed config built a ViT without remat")
    real = (len(train_loader.dataset), len(val_loader.dataset))
    print(f"  loaders: {real[0]} train images in {len(train_loader)} steps, {real[1]} "
          f"val images in {len(val_loader)} steps, batch {train_loader.batch_size}, "
          f"{train_loader.num_workers} workers", flush=True)
    step_fn = trainer.train_step
    train_log, val_log = [], []
    trainer.train_step = counted_steps(trainer.train_step, train_log)
    trainer.eval_step = counted_steps(trainer.eval_step, val_log)
    epoch_s = epoch_recorder(trainer, lambda epoch: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with no_plain_attention(fa):
        kernels.launches.clear()  # the ViT-B/16 trainer's path starts here
        trainer.fit(2)
        launches = dict(kernels.launches)  # ... and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    blocks = VIT_B16_224["model"]["num_blocks"]
    per_train, per_val = remat_launches(fa, blocks), {fa.KERNEL: blocks}
    check_step_launches({"train": train_log, "val": val_log},
                        {"train": per_train, "val": per_val},
                        {"train": 2 * len(train_loader), "val": 2 * len(val_loader)})
    print(f"  launches over fit(2): {launches} (per train step {per_train}, per val "
          f"step {per_val}); no plain attention ran", flush=True)
    finite_history(trainer, 2)
    check_predictions(run_dir, (1, 2), len(val_loader.dataset), trainer.history.history,
                      "ViT-B/16 trainer")
    meta = {name: json.loads((Path(save_path) / name / "metadata.json").read_text())
            for name in ("best_model", "last_model")}
    last = meta["last_model"]
    if (last["epoch"], last["mode"], last["config"]) != (2, "supervised", composed):
        fail(f"last_model metadata: epoch {last['epoch']}, mode {last['mode']}")
    print(f"  best_model: epoch {meta['best_model']['epoch']}, best_val_acc "
          f"{meta['best_model']['best_val_acc']:.6g}; last_model: epoch 2", flush=True)

    batch = trainer._put(next(iter(train_loader)))
    host_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        step_fn(trainer.state, batch)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    warm_ms = float(np.median(host_ms))
    b = VIT_B16_224["training"]["batch_size"]
    in_loop_ms = [t / len(train_loader) * 1e3 for t in epoch_s]
    for epoch, t in enumerate(epoch_s, 1):
        print(f"  epoch {epoch} on {card}: train {t:.3f} s wall for {real[0]} images "
              f"({real[0] / t:.1f} img/s; {in_loop_ms[epoch - 1]:.1f} ms a step), "
              f"input-wait share "
              f"{trainer.epoch_input_stats[epoch - 1]['wait_s'] / trainer.epoch_input_stats[epoch - 1]['wall_s']:.4f}",
              flush=True)
    print(f"  ViT-B/16 224 px training, remat on, batch {b}, on {card}: warm step "
          f"{warm_ms:.3f} ms median of 3 ({' / '.join(f'{x:.3f}' for x in host_ms)}; "
          f"{b / warm_ms * 1e3:.1f} img/s), host clock with torch.cuda.synchronize(), "
          f"device augmentation included; peak memory over fit(2) {peak_gb:.2f} GB "
          "(torch.cuda.max_memory_allocated)", flush=True)
    for save in trainer.save_times:
        print(f"  checkpoint {save['name']} of epoch {save['epoch']}: snapshot "
              f"{save['snapshot_ms']:.1f} ms, background write {save['write_s']:.3f} s",
              flush=True)
    idle, busy_ms = profile_window(torch, lambda: step_fn(trainer.state, batch),
                                   f"1 ViT-B/16 training step at batch {b} (remat)",
                                   rows=16)

    kernel_state, plain_state = copy.deepcopy(trainer.state), copy.deepcopy(trainer.state)
    got = step_fn(kernel_state, batch, with_grads=True)
    counted = dict(kernels.launches)
    with plain_attention():
        want = step_fn(plain_state, batch, with_grads=True)
    torch.cuda.synchronize()
    if dict(kernels.launches) != counted:
        fail("the plain-attention step launched a kernel")
    del kernel_state, plain_state

    def exact_step():
        exact_state = copy.deepcopy(trainer.state)
        with exact_attention(torch):
            return step_fn(exact_state, batch, with_grads=True)

    judge(torch, "plain attention", got, want, exact_step)
    del got, want, batch
    saved, _ = load_checkpoint(str(Path(save_path) / "last_model"))
    del trainer

    resumed, _, _ = trainer_for(save_path)
    resumed.resume_from(str(Path(save_path) / "last_model"))
    mismatch = state_mismatch(torch, to_host(resumed.state.state_dict()), saved)
    if mismatch or resumed.start_epoch != 2:
        fail(f"the resumed state differs from last_model at {mismatch} (start epoch "
             f"{resumed.start_epoch})")
    del saved
    resumed_log = []
    resumed.train_step = counted_steps(resumed.train_step, resumed_log)
    with no_plain_attention(fa):
        kernels.launches.clear()  # the resumed run starts here
        resumed.fit(1)
        resumed_launches = dict(kernels.launches)  # ... and ends here
    check_step_launches({"train": resumed_log}, {"train": per_train},
                        {"train": len(train_loader)})
    if resumed.state.step != 3 * len(train_loader):
        fail(f"the resumed epoch 3 ended at step {resumed.state.step}")
    print(f"  resumed from last_model: state bit-equal to the file; epoch 3 ended at "
          f"step {resumed.state.step}; launches {resumed_launches}", flush=True)
    del resumed
    gc.collect()
    return launches, resumed_launches, {"warm_ms": warm_ms, "peak_gb": peak_gb,
                                        "in_loop_ms": in_loop_ms, "busy_ms": busy_ms,
                                        "idle": idle}


def phase_remat(torch, fa, card):
    """The ViT-B/16 224-px step at batch REMAT_BATCH with ``parallel.remat``
    on and off from one cloned state: exact launches, agreement, each
    step's peak memory above what the states hold, each leg's device busy
    a step. Returns the launches of both legs."""
    from vit_ssl_tpu_torch import kernels

    cfg = copy.deepcopy(VIT_B16_224)
    cfg["training"]["batch_size"] = REMAT_BATCH
    blocks = cfg["model"]["num_blocks"]
    print(f"== remat against no remat: ViT-B/16 224 px train_step at batch "
          f"{REMAT_BATCH}, dropout 0.1, from one cloned state; {card}", flush=True)
    state, train_step, _, batch = build_supervised_training(torch, cfg)
    for _ in range(2):  # warm-up steps
        train_step(state, batch)
    start = copy.deepcopy(state)  # the fp64 yardstick's start, if judge needs it
    legs = {"remat": copy.deepcopy(state), "no remat": state}
    legs["no remat"].model.remat = False
    outs, peaks, paths = {}, {}, {}
    for name, leg in legs.items():
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with no_plain_attention(fa):
            kernels.launches.clear()  # the leg's step starts here
            outs[name] = train_step(leg, batch, with_grads=True)
            torch.cuda.synchronize()
            paths[name] = dict(kernels.launches)  # ... and ends here
        peaks[name] = (torch.cuda.max_memory_allocated() - resident) / 1e9
        want = remat_launches(fa, blocks, name == "remat")
        if paths[name] != want:
            fail(f"the {name} step launched {paths[name]}, expected {want}")
    same = torch.equal(outs["remat"]["loss"], outs["no remat"]["loss"]) and all(
        torch.equal(g, outs["no remat"]["grads"][k]) for k, g in outs["remat"]["grads"].items())
    print(f"  launches: remat {paths['remat']}, no remat {paths['no remat']}; loss and "
          f"gradients {'bit-equal' if same else 'not bit-equal'}", flush=True)

    def exact_step():
        with exact_attention(torch):
            return train_step(start, batch, with_grads=True)

    judge(torch, "no remat", outs["remat"], outs["no remat"], exact_step,
          names=("remat", "no remat"))
    del outs, start
    busy = {}
    for name, leg in legs.items():
        def three_steps(leg=leg):
            for _ in range(3):
                train_step(leg, batch)

        _, busy_ms = profile_window(torch, three_steps, f"3 training steps, {name}",
                                    rows=12)
        busy[name] = busy_ms / 3
    print(f"  on {card}: step peak above the resident states {peaks['remat']:.2f} GB "
          f"with remat, {peaks['no remat']:.2f} GB without ({peaks['remat'] / peaks['no remat']:.3f}x); "
          f"device busy a step {busy['remat']:.2f} ms with remat, {busy['no remat']:.2f} "
          f"ms without ({busy['remat'] / busy['no remat']:.3f}x)", flush=True)
    del legs, state
    return {"remat_step": paths["remat"], "no_remat_step": paths["no remat"]}


def simmim_launches(fa, blocks, microbatches=1):
    """B1's launches in one SimMIM training step: each block's training
    forward and backward once a microbatch."""
    return {fa.KERNEL_TRAIN: blocks * microbatches, fa.KERNEL_BWD: blocks * microbatches}


def set_dropout(model, rate):
    """Every dropout of ``model`` at ``rate``."""
    from vit_ssl_tpu_torch.ops import Dropout

    for module in model.modules():
        if isinstance(module, Dropout):
            module.rate = rate


def phase_simmim_trainer(torch, fa, card, tmp):
    """configs/simmim.yaml as written (SimMIM ViT-S/16 at 192 px, N = 144;
    its evaluation, KNN, linear probe and UMAP, after every epoch) through
    ``SimMIMTrainer.fit(2)`` over in-memory images, B1's launches exact in
    every step, each evaluation over EVAL_IMAGES labeled in-memory images;
    a fresh trainer resumed from last_model trains and evaluates epoch 3
    and ends bit-equal to a straight fit(3) (evaluating too); warm step,
    device busy, peak memory, the in-loop step and the input-wait share;
    one step against the plain-attention step from one cloned state.
    Returns the launches of both runs' training, the phase's numbers and the
    evaluations' launches."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.config import compose, to_container, validate_train_config
    from vit_ssl_tpu_torch.data.builder import make_loaders
    from vit_ssl_tpu_torch.models.builder import build_model
    from vit_ssl_tpu_torch.train.__main__ import get_save_path, get_trainer, save_run_config
    from vit_ssl_tpu_torch.train.trainers.base import to_host
    from vit_ssl_tpu_torch.utils.checkpoint import load_checkpoint

    configs = Path(__file__).resolve().parent / "configs"
    run_dir = str(Path(tmp) / "simmim")
    overrides = SIMMIM_OVERRIDES + [f"hydra.run.dir={run_dir}"]
    print(f"== SimMIM trainer: configs/simmim.yaml composed by vit_ssl_tpu_torch.config "
          f"as written (its evaluation after every epoch); fit(2) over {SIMMIM_IMAGES} "
          f"in-memory images (standing in for the host pipeline's output), each "
          f"evaluation over {EVAL_IMAGES} labeled ones, a resumed epoch 3 against a "
          f"straight fit(3); {card}", flush=True)
    plain = to_container(compose(configs, "simmim"))
    diffs = config_differences(SIMMIM_VIT_S16, plain)
    config = compose(configs, "simmim", overrides)
    validate_train_config(config)
    composed = to_container(config)
    diffs += [f"the overrides changed config.{k}" for k in composed
              if k not in ("eval", "hydra") and composed[k] != plain[k]]
    if diffs:
        fail("the composed configs/simmim.yaml differs from SIMMIM_VIT_S16: "
             + "; ".join(diffs))
    print("  composed config: training, model (mask_ratio 0.5), data, transforms and "
          "metrics as written, equal to SIMMIM_VIT_S16", flush=True)

    img = SIMMIM_VIT_S16["data"]["img_size"]
    images = np.random.default_rng(17).integers(0, 256, (SIMMIM_IMAGES, img, img, 3),
                                                dtype=np.uint8)
    evaluation_loaders = eval_loaders(config, img, seed=24)

    def trainer_for(path):
        train_loader, val_loader = make_loaders(config, InMemoryImages(images))
        trainer = get_trainer("simmim", build_model(config, "cuda"), path, config,
                              train_loader, val_loader, "cuda")
        trainer.eval_loaders = evaluation_loaders
        return trainer, train_loader, val_loader

    save_path = get_save_path(config)
    save_run_config(config, overrides, save_path)
    trainer, train_loader, val_loader = trainer_for(save_path)
    real = (len(train_loader.dataset), len(val_loader.dataset))
    print(f"  loaders: {real[0]} train images in {len(train_loader)} steps, {real[1]} "
          f"val images in {len(val_loader)} steps, batch {train_loader.batch_size}, "
          f"{train_loader.num_workers} workers", flush=True)
    step_fn = trainer.train_step
    train_log, val_log = [], []
    trainer.train_step = counted_steps(trainer.train_step, train_log)
    trainer.eval_step = counted_steps(trainer.eval_step, val_log)
    epoch_s = epoch_recorder(trainer, lambda epoch: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    recorder = EvalRecorder(torch)
    with no_plain_attention(fa), recorder.installed():
        kernels.launches.clear()  # the SimMIM trainer's path starts here
        trainer.fit(2)
        launches = dict(kernels.launches)  # ... and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fit_eval = recorder.launches()  # the extractions', counted as their own path
    launches = {k: v - fit_eval.get(k, 0) for k, v in launches.items()
                if v != fit_eval.get(k, 0)}
    blocks = SIMMIM_VIT_S16["model"]["num_blocks"]
    per_train, per_val = simmim_launches(fa, blocks), {fa.KERNEL: blocks}
    check_step_launches({"train": train_log, "val": val_log},
                        {"train": per_train, "val": per_val},
                        {"train": 2 * len(train_loader), "val": 2 * len(val_loader)})
    print(f"  launches over fit(2): {launches} (per train step {per_train}, per val "
          f"step {per_val}); no plain attention ran", flush=True)
    finite_history(trainer, 2)
    meta = {name: json.loads((Path(save_path) / name / "metadata.json").read_text())
            for name in ("best_model", "last_model")}
    last = meta["last_model"]
    if (last["epoch"], last["mode"], last["config"]) != (2, "simmim", composed):
        fail(f"last_model metadata: epoch {last['epoch']}, mode {last['mode']}")
    print(f"  best_model: epoch {meta['best_model']['epoch']}, best_val_score "
          f"{meta['best_model']['best_val_score']:.6g}; last_model: epoch 2", flush=True)
    step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(train_log[len(train_loader):],
                                                   train_log[len(train_loader) + 1:])]
    waits = [st["wait_s"] / st["wall_s"] for st in trainer.epoch_input_stats]
    del trainer

    resumed, _, _ = trainer_for(save_path)
    resumed.resume_from(str(Path(save_path) / "last_model"))
    saved, _ = load_checkpoint(str(Path(save_path) / "last_model"))
    mismatch = state_mismatch(torch, to_host(resumed.state.state_dict()), saved)
    if mismatch or resumed.start_epoch != 2:
        fail(f"the resumed state differs from last_model at {mismatch} (start epoch "
             f"{resumed.start_epoch})")
    del saved
    resumed_log = []
    resumed.train_step = counted_steps(resumed.train_step, resumed_log)
    with no_plain_attention(fa), recorder.installed():
        kernels.launches.clear()  # the resumed run starts here
        resumed.fit(1)
        resumed_launches = dict(kernels.launches)  # ... and ends here
    resumed_eval = {k: v - fit_eval.get(k, 0) for k, v in recorder.launches().items()}
    resumed_launches = {k: v - resumed_eval.get(k, 0) for k, v in resumed_launches.items()
                        if v != resumed_eval.get(k, 0)}
    check_step_launches({"train": resumed_log}, {"train": per_train},
                        {"train": len(train_loader)})
    straight, _, _ = trainer_for(str(Path(tmp) / "simmim_straight"))
    with no_plain_attention(fa):
        straight.fit(3)
    mismatch = state_mismatch(torch, to_host(resumed.state.state_dict()),
                              to_host(straight.state.state_dict()))
    if mismatch or resumed.state.step != 3 * len(train_loader):
        fail(f"the resumed epoch 3 (step {resumed.state.step}) differs from the "
             f"straight fit(3) at {mismatch}")
    print(f"  resumed from last_model: state bit-equal to the file; epoch 3 ended at "
          f"step {resumed.state.step}, bit-equal to a straight fit(3) (both evaluating "
          f"after every epoch); launches {resumed_launches}", flush=True)
    written = sorted(p.name for p in Path(save_path).iterdir() if p.name.startswith("epoch_"))
    if written != ["epoch_1", "epoch_2", "epoch_3"]:
        fail(f"the SimMIM trainer's evaluations wrote {written}")
    for epoch, (t, ev) in enumerate(zip(epoch_s, recorder.evaluations), 1):
        print(f"  epoch {epoch}: train {t:.3f} s wall, its evaluation {ev['wall_s']:.3f} s "
              "wall", flush=True)
    eval_launches = check_evaluations(torch, fa, recorder, blocks, "SimMIM")
    state, optimizer = resumed.state, resumed.optimizer
    del resumed, straight, recorder

    batch = {"image": torch.from_numpy(images[:128]).cuda(),
             "weight": torch.ones(128, device="cuda")}
    host_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    warm_ms = float(np.median(host_ms[2:]))
    b = SIMMIM_VIT_S16["training"]["batch_size"]
    for epoch, (t, wait) in enumerate(zip(epoch_s, waits), 1):
        print(f"  epoch {epoch} on {card}: train {t:.3f} s wall for {real[0]} images "
              f"({real[0] / t:.1f} img/s), input-wait share {wait:.4f}", flush=True)
    print(f"  SimMIM ViT-S/16 192 px training, batch {b}, on {card}: warm step "
          f"{warm_ms:.3f} ms median of 3 after 2 ({' / '.join(f'{x:.3f}' for x in host_ms)}; "
          f"{b / warm_ms * 1e3:.1f} img/s), host clock with torch.cuda.synchronize(); "
          f"the in-loop step (epoch 2, intervals between step starts) "
          f"{' / '.join(f'{x:.3f}' for x in step_ms)} ms; peak memory over fit(2) "
          f"{peak_gb:.2f} GB (torch.cuda.max_memory_allocated)", flush=True)
    idle, busy_ms = profile_window(
        torch, lambda: step_fn(state, batch), f"1 SimMIM training step at batch {b}",
        rows=16, counts={name: blocks for name in fa.BACKWARD_BODIES[
            fa.attention_nhd_bwd_form(144, 0, torch.bfloat16)]})

    kernel_state, plain_state = copy.deepcopy(state), copy.deepcopy(state)
    got = step_fn(kernel_state, batch, with_grads=True)
    counted = dict(kernels.launches)
    with plain_attention():
        want = step_fn(plain_state, batch, with_grads=True)
    torch.cuda.synchronize()
    if dict(kernels.launches) != counted:
        fail("the plain-attention step launched a kernel")
    for key in ("psnr_sse", "ssim_sum"):
        ratio = float(got[key]) / float(want[key])
        print(f"  {key}: kernel {float(got[key]):.6g}, plain {float(want[key]):.6g} "
              f"(ratio {ratio:.6f})", flush=True)
    del kernel_state, plain_state

    def exact_step():
        exact_state = copy.deepcopy(state)
        with exact_attention(torch):
            return step_fn(exact_state, batch, with_grads=True)

    judge(torch, "plain attention", got, want, exact_step)
    del got, want
    gc.collect()
    return launches, resumed_launches, state, optimizer, batch, {
        "warm_ms": warm_ms, "warm_ms_readings": host_ms, "busy_ms": busy_ms, "idle": idle,
        "peak_gb": peak_gb, "in_loop_ms": step_ms, "input_wait_share": waits,
        "epoch_s": epoch_s}, eval_launches


def phase_grad_accum(torch, fa, card, state, optimizer, batch):
    """One SimMIM step at grad_accum 4 and one DINO ViT-S/8 step at
    grad_accum 2, each against the same step at grad_accum 1 from one cloned
    state, dropout 0 (SimMIM at mask_ratio 1, so both mask every patch; the
    DINO views made once on the card and fed to both), held to judge's bars,
    B1's launches exact; then Bernoulli dropout's keep rate on the card
    within 4 sigma. Returns the launches of both accumulated steps."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.data.device_augment import make_multicrop_fn
    from vit_ssl_tpu_torch.ops import keep_mask_bernoulli
    from vit_ssl_tpu_torch.train import (AdamW, lr_schedule_from_config, make_dino_steps,
                                         make_simmim_steps)

    model = SIMMIM_VIT_S16["model"]
    blocks = model["num_blocks"]
    print(f"== gradient accumulation on {card}: SimMIM at grad_accum 4 and DINO ViT-S/8 "
          "at grad_accum 2, each against grad_accum 1 from one cloned state, dropout 0",
          flush=True)

    def accumulated(name, run, start, want_launches, accum, center=None):
        """``run(state, accum)`` at ``accum`` (launches exact) and at 1,
        from copies of ``start``, judged; returns the accumulated launches."""
        outs, paths, states = {}, {}, {}
        for a in (accum, 1):
            states[a] = copy.deepcopy(start)
            with no_plain_attention(fa):
                kernels.launches.clear()  # the accumulated step's path starts here
                outs[a] = run(states[a], a)
                torch.cuda.synchronize()
                paths[a] = dict(kernels.launches)  # ... and ends here
            want = {k: v * a for k, v in want_launches.items()}
            if paths[a] != want:
                fail(f"the {name} step at grad_accum {a} launched {paths[a]}, "
                     f"expected {want}")
        print(f"  {name}: launches at grad_accum {accum} {paths[accum]}, at 1 {paths[1]}",
              flush=True)
        # at mask_ratio 1 every token is the mask token: SimMIM's projection
        # takes no gradient, in either step, and has no cosine
        unused = [n for n, g in outs[1]["grads"].items()
                  if not g.any() and not outs[accum]["grads"][n].any()]
        if unused:
            print(f"  {name}: {unused} take no gradient in either step (zero in both)",
                  flush=True)
            for out in outs.values():
                out["grads"] = {n: g for n, g in out["grads"].items() if n not in unused}

        def exact_step():
            with exact_attention(torch):
                return run(copy.deepcopy(start), 1)

        judge(torch, "grad_accum 1", outs[accum], outs[1], exact_step,
              *((states[accum].center, states[1].center) if center else ()),
              names=(f"grad_accum {accum}", "grad_accum 1"))
        return paths[accum]

    start = copy.deepcopy(state)
    set_dropout(start.model, 0.0)
    start.model.mask_ratio = 1.0

    def simmim_run(leg, accum):
        step, _ = make_simmim_steps(optimizer, model["patch_size"], model["in_channels"],
                                    "l1", grad_accum=accum)
        return step(leg, batch, with_grads=True)

    simmim_path = accumulated("SimMIM", simmim_run, start, simmim_launches(fa, blocks), 4)
    del start

    cfg = copy.deepcopy(DINO_VIT_S8)
    cfg["model"]["dropout"] = 0.0
    dino_state, _, dino_batch = build_training(torch, cfg)
    train, dmodel = cfg["training"], cfg["model"]
    view_fn = make_multicrop_fn(cfg["transforms"]["globals"], cfg["transforms"]["locals"],
                                train["num_global_views"], train["num_all_views"])
    views = {"views": view_fn(torch.Generator(device="cuda").manual_seed(6),
                              dino_batch["image"]), "weight": dino_batch["weight"]}

    dino_optimizer = AdamW(lr_schedule_from_config(cfg, STL10_UNLABELED // train["batch_size"]),
                           weight_decay=train["optimizer"]["params"]["weight_decay"])

    def dino_run(leg, accum):
        step, _ = make_dino_steps(
            dino_optimizer, train["num_global_views"], train["num_all_views"],
            student_temp=train["student_temp"], center_momentum=dmodel["center_momentum"],
            teacher_dropout=train["teacher_dropout"], grad_accum=accum,
            pack_locals=dmodel["dino_pack_locals"])
        return step(leg, views, *schedule_values(), with_grads=True)

    dino_path = accumulated("DINO", dino_run, dino_state, attention_launches(fa), 2,
                            center=True)
    del dino_state, dino_batch, views

    rate, n = SIMMIM_VIT_S16["model"]["dropout"], 1 << 26
    keep = keep_mask_bernoulli((n,), rate, torch.Generator(device="cuda").manual_seed(7))
    kept = float(keep.float().mean())
    sigma = (rate * (1 - rate) / n) ** 0.5
    print(f"  Bernoulli dropout on the card: keep rate {kept:.6f} over {n} draws, "
          f"1 - rate {1 - rate:g}, |diff| {abs(kept - (1 - rate)) / sigma:.2f} sigma "
          "(<= 4)", flush=True)
    if abs(kept - (1 - rate)) > 4 * sigma:
        fail("Bernoulli dropout's keep rate is off by more than 4 sigma")
    del keep
    gc.collect()
    return {"grad_accum_step": simmim_path, "grad_accum_step_dino": dino_path}


def phase_simmim_serving(torch, fa, card, state, tmp):
    """The trained SimMIM model written as a ``.pth`` and served at batch
    128 through ``Server.forward_batch``: 6 B1 inference launches a batch
    and nothing else, padding rows inert, each row's embedding (the mean
    patch feature) at cosine >= 0.999 to the plain-attention forward's, and
    the warm batch. Returns the launches."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.serve import Server

    img, blocks = SIMMIM_VIT_S16["data"]["img_size"], SIMMIM_VIT_S16["model"]["num_blocks"]
    print(f"== SimMIM serving: the trained ViT-S/16 at {img} px (N=144), batch "
          f"{SERVE_BATCH}, mean patch features, bf16; {card}", flush=True)
    pth = f"{tmp}/simmim.pth"
    config = copy.deepcopy(SIMMIM_VIT_S16)
    torch.save({"model_state_dict": {k: v.detach().cpu() for k, v in
                                     state.model.state_dict().items()},
                "config": config, "epoch": 3}, pth)
    server = Server(pth, batch_size=SERVE_BATCH, device="cuda")
    x = np.random.default_rng(8).random((SERVE_BATCH, img, img, 3), np.float32)
    with no_plain_attention(fa):
        kernels.launches.clear()  # the SimMIM serving path starts here
        out = server.forward_batch(x)
        short = server.forward_batch(x[:37])
        launches = dict(kernels.launches)  # ... and ends here
    if launches != {fa.KERNEL: 2 * blocks}:
        fail(f"two served SimMIM batches launched {launches}, expected "
             f"{{{fa.KERNEL!r}: {2 * blocks}}}")
    embed = SIMMIM_VIT_S16["model"]["embed_dim"]
    if out.shape != (SERVE_BATCH, embed) or not np.isfinite(out).all():
        fail(f"SimMIM embeddings {out.shape} not finite ({SERVE_BATCH}, {embed})")
    pad_err = float(np.abs(short - out[:37]).max())
    with plain_attention(), torch.inference_mode():
        ref = server.model.inference_forward(torch.from_numpy(x).cuda()).float().cpu().numpy()
    if dict(kernels.launches) != launches:
        fail("the plain-attention SimMIM forward launched a kernel")
    cos = row_cosine(out, ref)
    print(f"  launches {launches}; padding rows: max_abs_diff {pad_err:.3e} (must be 0); "
          f"against plain attention: min row cosine {cos.min():.6f} (>= 0.999)",
          flush=True)
    if pad_err != 0.0 or cos.min() < 0.999:
        fail("the served SimMIM embeddings disagree with the plain attention path")
    warm_ms = warm_batch_ms(server, x)
    print(f"  SimMIM serving on {card}: warm batch {warm_ms:.3f} ms median of 10 "
          f"({SERVE_BATCH / warm_ms * 1e3:.1f} img/s), host clock incl. H2D/D2H",
          flush=True)
    return launches, warm_ms


def phase_b1_simmim_times(torch, fa, card):
    """B1's three entries at SimMIM's (128, 144, 6 x 64), bf16: kernel,
    plain, SDPA and bound (rows of the kernels line)."""
    b, n, h, d, dtype_name, bs = SIMMIM_B1_CASE
    print(f"== B1 at SimMIM's shape ({b},{n},{h}x{d}) {dtype_name} on {card}", flush=True)
    dtype = getattr(torch, dtype_name)
    xq, xk, xv = qkv(b, n, h, d, dtype, seed=320)
    (do,) = qkv(b, n, h, d, dtype, seed=321)[:1]
    scale = 1.0 / d ** 0.5
    bounds = attention_train_bounds(b, n, h, d, dtype_name, bs)
    return {
        "fwd": b1_forward_row(torch, fa, fa.KERNEL, ", SimMIM eval", xq, xk, xv, h,
                              scale, bs, attention_bound(b, n, h, d, dtype_name, bs)),
        "fwd_stats": b1_forward_row(torch, fa, fa.KERNEL_TRAIN, ", SimMIM training",
                                    xq, xk, xv, h, scale, bs, bounds["fwd"]),
        "bwd": b1_backward_row(torch, fa, xq, xk, xv, do, h, scale, bs, bounds["bwd"]),
    }


# (entry, T, keep-mask, (d_model, d_ff)): at DINO ViT-S/8's width the
# training forward at the student's globals and packed locals, the teacher's
# forward, the served forward, the backward at the two student shapes; at
# ViT-B/16's (384 px, batch 64) and ViT-L/16's (224 px, batch 64) the served
# forward, the training forward and the backward
VIT_B_MLP, VIT_L_MLP = (768, 3072), (1024, 4096)
MLP_TIMED = [
    ("fwd_pre", 37120, True, MLP_DIMS), ("fwd_pre", 18944, True, MLP_DIMS),
    ("fwd", 37120, True, MLP_DIMS), ("fwd", 18560, False, MLP_DIMS),
    ("bwd", 37120, True, MLP_DIMS), ("bwd", 18944, True, MLP_DIMS),
    ("fwd", 36928, False, VIT_B_MLP), ("fwd_pre", 36928, True, VIT_B_MLP),
    ("bwd", 36928, True, VIT_B_MLP),
    ("fwd", 12608, False, VIT_L_MLP), ("fwd_pre", 12608, True, VIT_L_MLP),
    ("bwd", 12608, True, VIT_L_MLP),
]


def phase_mlp_times(torch, fm, card):
    """Kernel B4 (bf16) at the main paths' token counts and widths
    (:func:`mlp_time_row` each, with its profile)."""
    print(f"== fused MLP times on {card} (bf16; the unfused chain is F.linear -> "
          f"GELU -> dropout16's where/divide on the same mask -> F.linear)",
          flush=True)
    return {(part, t, dims[0]): mlp_time_row(torch, fm, part, t, with_mask, dims)
            for part, t, with_mask, dims in MLP_TIMED}


def mlp_time_row(torch, fm, part, t, with_mask, dims, profile=True):
    """Kernel B4's entry ``part`` (bf16) at T = ``t`` and ``dims`` = (d_model,
    d_ff): kernel ms twice around its plain version and the unfused FFN
    chain of the same function (its forward, or its autograd backward),
    CUDA events; the wrapper's host microseconds a call; with ``profile``, a
    profile of five calls, which must name the entry's Hopper kernels
    (``fm.HOPPER_BODIES``). Returns the row of the kernels line."""
    d, d_ff = dims
    x, w1, b1, w2, b2, mask, do = mlp_inputs(torch, t, torch.bfloat16, seed=500, dims=dims)
    mask = mask if with_mask else None
    args = (x, w1, b1, w2, b2, mask, KEEP_PROB)
    if part == "bwd":
        _, pre = fm.fused_mlp_fwd(*args, save_pre=True)
        ins = [y.detach().requires_grad_() for y in (x, w1, b1, w2, b2)]
        chain_out = unfused_ffn(torch, *ins, mask, KEEP_PROB)

        def kernel():
            return fm.fused_mlp_bwd(x, pre, do, w1, w2, mask, KEEP_PROB)

        def plain():
            return fm.fused_mlp_bwd_reference(x, pre, do, w1, w2, mask, KEEP_PROB)

        def chain():
            return torch.autograd.grad(chain_out, ins, do, retain_graph=True)
    else:
        save_pre = part == "fwd_pre"

        def kernel():
            return fm.fused_mlp_fwd(*args, save_pre=save_pre)

        def plain():
            return fm.fused_mlp_reference(*args, save_pre=save_pre)

        def chain():
            return unfused_ffn(torch, *args)
    first = cuda_ms(kernel)
    plain_ms = cuda_ms(plain, iters=10)
    chain_ms = cuda_ms(chain)
    second = cuda_ms(kernel)
    wrapper_us = host_us(kernel)
    bounds = mlp_bounds(t, d, d_ff, "bfloat16", with_mask, part == "fwd_pre")
    bound_ms, bound_by = bounds["bwd" if part == "bwd" else "fwd"]
    name = {"fwd": fm.KERNEL, "fwd_pre": fm.KERNEL_TRAIN, "bwd": fm.KERNEL_BWD}[part]
    print(f"  {name} T={t} {d}->{d_ff} {'keep-mask' if with_mask else 'no mask'}: "
          f"kernel {first:.4f} / {second:.4f} ms, plain {plain_ms:.4f} ms, unfused "
          f"chain {chain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); the "
          f"wrapper {wrapper_us:.1f} us a call on the host", flush=True)
    if profile:
        profile_window(torch, lambda: [kernel() for _ in range(5)],
                       f"5 {name} calls at T={t}, d_model {d} (its kernels)", rows=5,
                       want=fm.HOPPER_BODIES[name])
    return {"ms": min(first, second), "ms_readings": [first, second],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "unfused_chain_ms": chain_ms, "wrapper_host_us": wrapper_us,
            "shape": [t, d, d_ff]}


def masked_bounds(t, d_ff, d_out, dtype):
    """{"fwd": (ms, by), "bwd": (ms, by)} of kernel P2 over t tokens. The
    forward reads h, the 1-byte keep-mask, w2 and b2 and writes o: one
    product. The backward reads h, the mask, do and w2 and writes dh, dw2
    and db2: two products (dh, dw2)."""
    itemsize = 2 if dtype == "bfloat16" else 4
    act, mask_bytes, out = t * d_ff * itemsize, t * d_ff, t * d_out * itemsize
    weights = (d_out * d_ff + d_out) * itemsize
    ops = 2 * t * d_ff * d_out
    return {"fwd": _bound(act + mask_bytes + weights + out, ops, dtype),
            "bwd": _bound(2 * act + mask_bytes + out + 2 * weights, 2 * ops, dtype)}


def phase_masked_times(torch, mm, card):
    """Kernel P2 (bf16) at the probe's shape, the DINO student-globals FFN,
    and at ViT-B/16's FFN (384 px): kernel ms twice around its plain
    version and the unfused PyTorch pair (dropout16's where/divide on the
    same mask, then F.linear, or its autograd backward), CUDA events; the
    wrapper's host microseconds a call; a profile of five calls of each
    entry, which must name its Hopper kernels. Returns rows by (part, T)."""
    import torch.nn.functional as F

    print(f"== masked matmul (P2) times on {card} (bf16; the library column is "
          f"torch.where dropout then F.linear on the same inputs and mask)", flush=True)
    rows = {}
    for t, d_ff, d_out in (MASKED_CASES[0], MASKED_CASES[3]):
        h, mask, w2, b2, do = masked_inputs(torch, t, d_ff, d_out, torch.bfloat16, seed=700)
        ins = [y.detach().requires_grad_() for y in (h, w2, b2)]

        def pair(h, w2, b2):
            return F.linear(torch.where(mask, h / KEEP_PROB, h.new_zeros(())), w2, b2)

        pair_out = pair(*ins)
        legs = {
            "fwd": (lambda: mm.masked_matmul_fwd(h, mask, w2, b2, KEEP_PROB),
                    lambda: mm.masked_matmul_reference(h, mask, w2, b2, KEEP_PROB),
                    lambda: pair(h, w2, b2)),
            "bwd": (lambda: mm.masked_matmul_bwd(h, mask, do, w2, KEEP_PROB),
                    lambda: mm.masked_matmul_bwd_reference(h, mask, do, w2, KEEP_PROB),
                    lambda: torch.autograd.grad(pair_out, ins, do, retain_graph=True)),
        }
        bounds = masked_bounds(t, d_ff, d_out, "bfloat16")
        for part, (kernel, plain, library) in legs.items():
            first = cuda_ms(kernel)
            plain_ms = cuda_ms(plain, iters=10)
            library_ms = cuda_ms(library)
            second = cuda_ms(kernel)
            wrapper_us = host_us(kernel)
            bound_ms, bound_by = bounds[part]
            name = mm.KERNEL if part == "fwd" else mm.KERNEL_BWD
            print(f"  {name} T={t} {d_ff}->{d_out}: kernel {first:.4f} / {second:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, where + F.linear {library_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}); the wrapper {wrapper_us:.1f} us a call "
                  f"on the host", flush=True)
            rows[(part, t)] = {"ms": min(first, second), "ms_readings": [first, second],
                               "plain_ms": plain_ms, "bound_ms": bound_ms,
                               "bound_by": bound_by, "library_ms": library_ms,
                               "shape": [t, d_ff, d_out], "wrapper_host_us": wrapper_us,
                               "library_is": "torch.where dropout then F.linear (addmm)"
                                             + (", its autograd backward" if part == "bwd"
                                                else "")}
            profile_window(torch, lambda: [kernel() for _ in range(5)],
                           f"5 {name} calls at T={t} (its kernels)", rows=4,
                           want=P2_BODIES[name], absent=P2_MMA_SYNC_BODIES)
        del h, mask, w2, b2, do, ins, pair_out, legs
        torch.cuda.empty_cache()
    return rows


def phase_dropout_probe(torch, fm, mm, card):
    """The dropout-epilogue probe
    (``vit_ssl_tpu_torch/scripts/dropout_epilogue_probe.py``), P2's path:
    the epilogue FFN checked against the plain FFN, then the five legs
    timed, the derived lines and the verdict. Returns its launches."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.scripts import dropout_epilogue_probe as probe

    print(f"== dropout-epilogue probe on {card}: masked_mm_fwd / masked_mm_bwd (P2) "
          f"in the FFN against dropout as plain passes, bf16", flush=True)
    with no_plain_mlp(fm), no_plain_masked(mm):
        kernels.launches.clear()  # the probe's run starts here
        result = probe.probe()
        launches = dict(kernels.launches)  # ... and ends here
    probe.report(result, card)
    print(f"  launches: {launches}", flush=True)
    for name in (mm.KERNEL, mm.KERNEL_BWD, fm.KERNEL_TRAIN, fm.KERNEL_BWD):
        if not launches.get(name):
            fail(f"the probe did not launch {name}")
    return launches, result


def build_vit_model(torch, seed, cfg=VIT_B16_384):
    """The config's ViT on the CPU, every parameter drawn with the
    reference init from ``torch.Generator().manual_seed(seed)``."""
    from vit_ssl_tpu_torch.models import build_vit

    return build_vit(cfg, "cpu").reset_parameters(torch.Generator().manual_seed(seed))


def top2_margin(logits):
    """Each row's gap between its largest and second-largest logit."""
    top = np.sort(logits, axis=1)[:, -2:]
    return top[:, 1] - top[:, 0]


def phase_supervised_serving(torch, fa, tmp, card, cfg, per_forward, guards=(),
                             fused=False):
    """The supervised ViT-B/16 of ``cfg`` served from a written ``.pth``:
    exactly ``per_forward`` launches a batch (at 384 px 12 of B3's inference
    forward, and with ``model.use_fused_mlp=true`` (``fused``) 12 of B4's
    forward too; at 512 px 12 of B2's forward) and nothing else under the
    plain-version ``guards``, padding rows inert, logits within row cosine
    0.999 of the reference server and the same preds (a pred may differ
    only where the reference logits' top two lie closer than twice the
    largest logit difference), warm batch and a profile. The reference is
    the same server on plain attention, or, when ``fused``, with every FFN
    unfused. Returns the path's launches."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.ops import fused_mlp as fm
    from vit_ssl_tpu_torch.serve import Server

    batch, img = cfg["training"]["batch_size"], cfg["data"]["img_size"]
    n = (img // cfg["model"]["patch_size"]) ** 2 + 1
    print(f"== supervised serving: ViT-B/16, batch {batch}, img {img} (N={n}, "
          f"12 heads of 64), bf16, full depth, kernels {sorted(per_forward)}", flush=True)
    pth = f"{tmp}/vit_b16_{img}.pth"
    model = build_vit_model(torch, 5, cfg)
    torch.save({"model_state_dict": model.state_dict(), "config": cfg, "epoch": 0}, pth)
    del model
    server = Server(pth, batch_size=batch, device="cuda")
    x = np.random.default_rng(5).random((batch, img, img, 3), np.float32)

    with contextlib.ExitStack() as stack:
        for guard in (no_plain_attention(fa), *guards):
            stack.enter_context(guard)
        kernels.launches.clear()  # the supervised serving path's run starts here
        out = server.forward_batch(x)
        first = dict(kernels.launches)
        short = server.forward_batch(x[:37])
        main_launches = dict(kernels.launches)  # ... and ends here
    print(f"  launches: {main_launches} ({first} in the first forward)", flush=True)
    if first != per_forward or main_launches != {k: 2 * v for k, v in per_forward.items()}:
        fail(f"expected {per_forward} launches per forward and nothing else, got "
             f"{first} then {main_launches}")
    classes = cfg["model"]["num_classes"]
    if out.shape != (batch, classes) or not np.isfinite(out).all():
        fail(f"logits {out.shape} not finite ({batch}, {classes})")
    pad_err = float(np.abs(short - out[:37]).max())
    print(f"  padding: short batch of 37 vs full batch rows, max_abs_diff "
          f"{pad_err:.3e} (must be 0)", flush=True)
    if pad_err != 0.0:
        fail("zero-padding rows changed real rows")

    reference = ffn_unfused(server.model) if fused else plain_attention()
    ref_name = "the unfused FFN" if fused else "plain attention"
    with reference, torch.inference_mode():
        ref = server.model(torch.from_numpy(x).cuda()).float().cpu().numpy()
    extra = {k: v - main_launches.get(k, 0) for k, v in kernels.launches.items()
             if v != main_launches.get(k, 0)}
    # the unfused reference still runs B3; neither reference may run B4
    if [k for k in extra if not fused or k.startswith("fused_mlp")]:
        fail(f"the reference run ({ref_name}) launched {extra}")
    cos = row_cosine(out, ref)
    max_err = float(np.abs(out - ref).max())
    differ = out.argmax(1) != ref.argmax(1)
    near_tie = top2_margin(ref) <= 2 * max_err
    print(f"  against {ref_name} on the card: min row cosine {cos.min():.6f} "
          f"(>= 0.999), logits max_abs_err {max_err:.3e}; preds differ in "
          f"{int(differ.sum())} of {batch} rows, {int((differ & ~near_tie).sum())} "
          f"of them outside a near tie (must be 0)", flush=True)
    if cos.min() < 0.999 or (differ & ~near_tie).any():
        fail(f"supervised serving disagrees with {ref_name}")
    warm_ms = warm_batch_ms(server, x)
    print(f"  supervised serving on {card}: warm batch {warm_ms:.3f} ms median of 10 "
          f"({batch / warm_ms * 1e3:.1f} img/s), host clock incl. H2D/D2H; start-up "
          f"warm batch {server.warm_s * 1e3:.3f} ms", flush=True)

    def three_batches():
        for _ in range(3):
            server.forward_batch(x)

    profile_window(torch, three_batches, f"3 supervised serving batches at {img} px"
                   + (" (fused FFN)" if fused else ""), rows=16)
    return main_launches


def build_supervised_training(torch, cfg=VIT_B16_384):
    """The ViT's train state on the card (seeded weights, AdamW on the
    config's schedule with ImageNet-1k's steps per epoch at the global
    batch), its steps with the config's train augmentation on the card, and
    a batch of uint8 images with labels."""
    from vit_ssl_tpu_torch.data.device_augment import make_batch_augment_fn
    from vit_ssl_tpu_torch.train import (
        AdamW, SupervisedTrainState, lr_schedule_from_config, make_supervised_steps)

    train = cfg["training"]
    steps_per_epoch = int(IMAGENET_TRAIN * (1 - cfg["data"]["val_split"])) // GLOBAL_BATCH
    optimizer = AdamW(lr_schedule_from_config(cfg, steps_per_epoch),
                      weight_decay=train["optimizer"]["params"]["weight_decay"])
    state = SupervisedTrainState(build_vit_model(torch, 6, cfg).to("cuda"), optimizer,
                                 seed=7)
    train_step, eval_step = make_supervised_steps(
        optimizer, augment_fn=make_batch_augment_fn(cfg["transforms"]["train"]))
    b, img = train["batch_size"], cfg["data"]["img_size"]
    rng = np.random.default_rng(8)
    batch = {"image": torch.from_numpy(rng.integers(0, 256, (b, img, img, 3),
                                                    dtype=np.uint8)).cuda(),
             "label": torch.from_numpy(rng.integers(0, cfg["model"]["num_classes"], b)).cuda(),
             "weight": torch.ones(b, device="cuda")}
    return state, train_step, eval_step, batch


# ViT-B/16, (img, fused FFN) -> (warm step ms, device busy ms a step, peak
# GB) of this script's runs on the mma.sync backwards that
# attention_bwd_sm90.cuh replaced (NVIDIA H100 80GB HBM3, 700 W): B3's at
# 384 px, B2's at 512 px
SUPERVISED_BEFORE = {(384, False): (124.791, 120.38, 16.79),
                     (384, True): (193.324, 188.31, 14.12),
                     (512, False): (211.792, 209.05, 29.72)}


def phase_supervised_training(torch, fa, card, cfg, per_step, per_eval, suffix,
                              guards=(), fused=False, profiled=None, absent=()):
    """The ViT-B/16 training step of ``cfg`` at batch 64: two warm-up
    steps, then TIMED_STEPS steps under the plain-version guards, each
    launching exactly ``per_step`` (at 384 px 12 each of B3's training
    forward and backward, and with ``fused`` 12 each of B4's training
    forward and backward; at 512 px 12 each of B2's forward, dq and dk/dv
    kernels); losses finite, every parameter moved; peak memory; agreement
    with the reference step from one cloned state (plain attention, or,
    when ``fused``, the unfused FFN); ``eval_step``'s ``per_eval``
    launches; a profile of three steps (``profiled``: kernel name -> its
    launches in them; ``absent``: names no kernel of theirs may hold).
    Returns the launches of the training and eval paths, named with
    ``suffix``."""
    from vit_ssl_tpu_torch import kernels

    b, img = cfg["training"]["batch_size"], cfg["data"]["img_size"]
    print(f"== supervised training: ViT-B/16 train_step, batch {b}, img {img} "
          f"(N={(img // cfg['model']['patch_size']) ** 2 + 1}), dropout 0.1, bf16, "
          f"full depth, remat off, RandomResizedCrop + flip on the card from uint8, "
          f"kernels {sorted(per_step)}", flush=True)
    state, train_step, eval_step, batch = build_supervised_training(torch, cfg)
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    for _ in range(2):  # warm-up steps
        out = train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, host_ms = [float(out["loss"])], []
    with contextlib.ExitStack() as stack:
        for guard in (no_plain_attention(fa), *guards):
            stack.enter_context(guard)
        kernels.launches.clear()  # the supervised training path's run starts here
        for _ in range(TIMED_STEPS):
            counted = dict(kernels.launches)
            t0 = time.perf_counter()
            out = train_step(state, batch)
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(out["loss"]))
            step_launches = {k: v - counted.get(k, 0) for k, v in kernels.launches.items()}
            if step_launches != per_step:
                fail(f"a supervised step launched {step_launches}, expected {per_step}")
        train_launches = dict(kernels.launches)  # ... and ends here
        kernels.launches.clear()  # the eval step's run starts here
        ev = eval_step(state, batch)
        torch.cuda.synchronize()
        eval_launches = dict(kernels.launches)  # ... and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  launches over {TIMED_STEPS} steps: {train_launches} (per step "
          f"{per_step}); eval_step: {eval_launches}", flush=True)
    print(f"  losses: {' '.join(f'{x:.6f}' for x in losses)}; eval loss "
          f"{float(ev['loss']):.6f}", flush=True)
    if eval_launches != per_eval:
        fail(f"eval_step launched {eval_launches}, expected {per_eval}")
    if not all(np.isfinite(losses + [float(ev["loss"])])):
        fail("a supervised loss is not finite")
    moved = [k for k, v in state.model.state_dict().items()
             if not torch.equal(before[k], v)]
    print(f"  parameters: {len(moved)} of {len(before)} tensors changed", flush=True)
    if len(moved) != len(before):
        fail("a supervised step left a parameter unchanged")
    warm_ms = float(np.median(host_ms))
    before_pr = SUPERVISED_BEFORE.get((img, fused))
    print(f"  supervised training at {img} px on {card}: warm step {warm_ms:.3f} ms median of "
          f"{TIMED_STEPS} ({b / warm_ms * 1e3:.1f} img/s), host clock with "
          f"torch.cuda.synchronize(), device augmentation included; peak memory "
          f"{peak_gb:.2f} GB (torch.cuda.max_memory_allocated)"
          + (f"; before the Hopper backward: {before_pr[0]} ms, {before_pr[2]} GB"
             if before_pr else ""), flush=True)

    kernel_state, ref_state = copy.deepcopy(state), copy.deepcopy(state)
    got = train_step(kernel_state, batch, with_grads=True)
    counted = dict(kernels.launches)
    reference = ffn_unfused(ref_state.model) if fused else plain_attention()
    with reference:
        want = train_step(ref_state, batch, with_grads=True)
    torch.cuda.synchronize()
    extra = [k for k, v in kernels.launches.items() if v != counted.get(k, 0)]
    # the unfused reference still runs B3; neither reference may run B4
    if [k for k in extra if not fused or k.startswith("fused_mlp")]:
        fail(f"the reference step launched {extra}")
    del kernel_state, ref_state

    def exact_step():
        exact_state = copy.deepcopy(state)
        if fused:
            set_fused((exact_state.model,), False)
        with exact_attention(torch):
            return train_step(exact_state, batch, with_grads=True)

    judge(torch, "the unfused FFN" if fused else "plain attention", got, want,
          exact_step, names=("fused", "unfused") if fused else ("kernel", "plain"))
    del got, want

    def three_steps():
        for _ in range(3):
            train_step(state, batch)

    _, busy_ms = profile_window(torch, three_steps, f"3 supervised training steps at {img} px"
                                + (" (fused FFN)" if fused else ""), rows=25,
                                counts=profiled, absent=absent)
    print(f"  device busy a step {busy_ms / 3:.2f} ms"
          + (f" (before the Hopper backward: {before_pr[1]} ms)" if before_pr else ""),
          flush=True)
    return {"training_supervised" + suffix: train_launches,
            "eval_supervised" + suffix: eval_launches}


# B3's bf16 entries at (64, 12, 577, 64) on the mma.sync bodies that
# attention_fwd_sm90.cuh and attention_bwd_sm90.cuh replaced (B1's bodies
# on the head-major layout), as this script measured them on an NVIDIA
# H100 80GB HBM3 at 700 W. B1 on the same data, timed beside, runs the same
# forward body as B3 (its two-pass form) and the mma.sync backward.
B3_MMA_SYNC_MS = {"fwd": 0.7726, "fwd_stats": 0.7659, "bwd": 1.5807}
# and its dq/dk/dv errors at FUSED_CASES[0], over max|plain| (the same run)
B3_MMA_SYNC_GRAD_ERRS = (1.3e-3, 1.3e-3, 2.0e-3)


def heads_time_rows(torch, fa, fb, route, q, k, v, do, same_data=None, before=None):
    """B3's (``route`` "B3") or B2's ("B2") three bf16 entries on the
    contiguous (B, H, N, D) heads q, k, v and cotangent do, CUDA events: each
    kernel twice around its plain version (B2's backward kernels: the whole
    plain backward, which computes both), then SDPA on the same heads
    (forward; for a backward its whole autograd backward), then
    ``same_data``'s (label, {part: function}) on the same data; ``before``:
    each part's ms on the body the kernel replaced, printed beside. Returns
    ({part: row}, {part: the kernel's call})."""
    import torch.nn.functional as F

    b, h, n, d = q.shape
    dtype_name = str(q.dtype).split(".")[-1]
    scale = 1.0 / d ** 0.5
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(q, k, v, scale=scale)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qg, kg, vg), do, retain_graph=True)

    if route == "B3":
        _, stats = fa.fused_attention_fwd_stats(q, k, v, scale)
        bounds = attention_train_bounds(b, n, h, d, dtype_name, 0)
        parts = {
            "fwd": (fa.FUSED_KERNEL, lambda: fa.fused_attention_fwd(q, k, v, scale),
                    lambda: fa.fused_attention_reference(q, k, v, scale), sdpa_fwd,
                    attention_bound(b, n, h, d, dtype_name, 0)),
            "fwd_stats": (fa.FUSED_KERNEL_TRAIN,
                          lambda: fa.fused_attention_fwd_stats(q, k, v, scale),
                          lambda: (fa.fused_attention_reference(q, k, v, scale),
                                   fa.fused_attention_stats_reference(q, k, scale)),
                          sdpa_fwd, bounds["fwd"]),
            "bwd": (fa.FUSED_KERNEL_BWD,
                    lambda: fa.fused_attention_bwd(q, k, v, do, stats, scale),
                    lambda: fa.fused_attention_bwd_reference(q, k, v, do, scale),
                    sdpa_bwd, bounds["bwd"])}
    else:
        out, lse = fb.blockwise_attention_fwd(q, k, v, scale)
        _, delta = fb.blockwise_attention_bwd_dq(q, k, v, out, lse, do, scale)
        bounds = blockwise_bounds(b, h, n, d, dtype_name)

        def plain_bwd():
            return fb.blockwise_attention_bwd_reference(q, k, v, out, lse, do, scale)

        parts = {
            "fwd": (fb.KERNEL, lambda: fb.blockwise_attention_fwd(q, k, v, scale),
                    lambda: fb.blockwise_attention_reference(q, k, v, scale,
                                                             fb.KERNEL_BLOCK_K),
                    sdpa_fwd, bounds["fwd"]),
            "dq": (fb.KERNEL_DQ,
                   lambda: fb.blockwise_attention_bwd_dq(q, k, v, out, lse, do, scale),
                   plain_bwd, sdpa_bwd, bounds["dq"]),
            "dkv": (fb.KERNEL_DKV,
                    lambda: fb.blockwise_attention_bwd_dkv(q, k, v, do, lse, delta, scale),
                    plain_bwd, sdpa_bwd, bounds["dkv"])}
    rows = {}
    for part, (name, kernel, plain, library, (bound_ms, bound_by)) in parts.items():
        first = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, iters=10)
        library_ms = cuda_ms(library)
        rows[part] = {"ms": None, "ms_readings": None, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                      "shape": [b, h, n, d]}
        extra = ""
        if same_data is not None:
            label, fns = same_data
            ms = cuda_ms(fns[part])
            rows[part][label.replace(" ", "_") + "_ms"] = ms
            extra = f", {label} {ms:.4f} ms"
        second = cuda_ms(kernel)
        rows[part].update(ms=min(first, second), ms_readings=[first, second])
        replaced = "" if not before or part not in before else \
            f", the mma.sync body it replaced {before[part]} ms"
        print(f"  {name} ({b},{h},{n},{d}) {dtype_name}: kernel {first:.4f} / {second:.4f} "
              f"ms{replaced}, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms{extra}, "
              f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return rows, {part: entry[1] for part, entry in parts.items()}


def phase_fused_times(torch, fa, card):
    """B3's three entries at ViT-B/16's (64, 12, 577, 64) bf16
    (:func:`heads_time_rows`), with B1 on the same data in its (64, 577,
    768) layout timed beside, and the mma.sync body's recorded times. Then
    profiles of 5 forward calls and 5 backward calls, which must show the
    Hopper kernels by name. Returns the JSON rows."""
    b, h, n, d, dtype_name = FUSED_CASES[0]
    print(f"== B3 times on {card}: ({b},{h},{n},{d}) {dtype_name}", flush=True)
    q, k, v, do = heads_qkv(b, h, n, d, getattr(torch, dtype_name), seed=700, count=4)
    scale = 1.0 / d ** 0.5

    def nhd(x):
        return x.transpose(1, 2).reshape(b, n, h * d).contiguous()

    xq, xk, xv, xdo = (nhd(x) for x in (q, k, v, do))
    _, b1_stats = fa.attention_nhd_fwd_stats(xq, xk, xv, h, scale)
    b1 = {"fwd": lambda: fa.attention_nhd_fwd(xq, xk, xv, h, scale),
          "fwd_stats": lambda: fa.attention_nhd_fwd_stats(xq, xk, xv, h, scale),
          "bwd": lambda: fa.attention_nhd_bwd(xq, xk, xv, xdo, b1_stats, h, scale)}
    rows, calls = heads_time_rows(torch, fa, None, "B3", q, k, v, do,
                                  same_data=("b1 same data", b1), before=B3_MMA_SYNC_MS)
    profile_window(torch, lambda: [calls["fwd"]() for _ in range(5)],
                   "5 fused_attention_fwd calls (the Hopper body)", rows=4,
                   want="attention_fwd_sm90_kernel")
    profile_window(torch, lambda: [calls["bwd"]() for _ in range(5)],
                   "5 fused_attention_bwd calls (the Hopper body's two kernels)", rows=4,
                   want=("attention_bwd_dq_sm90_kernel", "attention_bwd_dkv_sm90_kernel"))
    return rows


# B2's bf16 backward: each C entry's Hopper body (attention_bwd_sm90.cuh),
# and the mma.sync bodies they replaced, with those bodies' times at
# (64, 12, 1025, 64) as this script measured them through the wrapper on an
# NVIDIA H100 80GB HBM3 at 700 W; printed beside this run's, never in the
# kernels line
B2_BWD_BODIES = {"blockwise_bwd_dq": "blockwise_bwd_dq_sm90_kernel",
                 "blockwise_bwd_dkv": "blockwise_bwd_dkv_sm90_kernel"}
B2_MMA_SYNC_BODIES = ("blockwise_dq_bf16_kernel", "blockwise_dkv_bf16_kernel")
B2_MMA_SYNC_MS = {"dq": 1.2437, "dkv": 1.7576}


def phase_blockwise_times(torch, fb, card):
    """B2's three entries at ViT-B/16's (64, 12, 1025, 64) bf16
    (:func:`heads_time_rows`: the forward's plain version at the kernel's
    key tile, the dq and dk/dv kernels' the whole plain backward; SDPA's
    whole backward beside both), and the mma.sync backward's recorded
    times. Then a profile of 5 backward calls, which must show the Hopper
    bodies 5 times each and no mma.sync body. Returns the JSON rows."""
    b, h, n, d, dtype_name = BLOCKWISE_CASES[0]
    print(f"== B2 times on {card}: ({b},{h},{n},{d}) {dtype_name}", flush=True)
    q, k, v, do = heads_qkv(b, h, n, d, getattr(torch, dtype_name), seed=950, count=4)
    scale = 1.0 / d ** 0.5
    rows, _ = heads_time_rows(torch, None, fb, "B2", q, k, v, do, before=B2_MMA_SYNC_MS)
    for part, name in (("dq", fb.KERNEL_DQ), ("dkv", fb.KERNEL_DKV)):
        rows[part].update(body=B2_BWD_BODIES[name], plain_is="the whole plain backward",
                          library_is="SDPA's whole backward")
    print(f"  the pair: {rows['dq']['ms'] + rows['dkv']['ms']:.4f} ms, SDPA's whole backward "
          f"{rows['dq']['library_ms']:.4f} ms, the mma.sync pair "
          f"{B2_MMA_SYNC_MS['dq'] + B2_MMA_SYNC_MS['dkv']:.4f} ms", flush=True)
    f32 = [x.float() for x in (q, k, v)]
    f32_ms = cuda_ms(lambda: fb.blockwise_attention_fwd(*f32, scale), iters=10)
    f32_bound = blockwise_bounds(b, h, n, d, "float32")["fwd"]
    print(f"  {fb.KERNEL} float32 (CUDA cores): kernel {f32_ms:.4f} ms, bound "
          f"{f32_bound[0]:.4f} ms ({f32_bound[1]})", flush=True)
    out, lse = fb.blockwise_attention_fwd(q, k, v, scale)
    profile_window(torch, lambda: [fb.blockwise_attention_bwd(q, k, v, out, lse, do, scale)
                                   for _ in range(5)],
                   "5 blockwise_attention_bwd calls (its two kernels)", rows=6,
                   counts={body: 5 for body in B2_BWD_BODIES.values()},
                   absent=B2_MMA_SYNC_BODIES)
    return rows


def phase_exp2_probe(torch, fb, card):
    """The exp2 probe (``vit_ssl_tpu_torch/scripts/exp2_probe.py``), P1's
    path: P1 against B2's forward at the probe's shapes, both timed. Then,
    apart from the path, P1 against its plain version at the kernel's key
    tile (bf16 atol 1e-2 rtol 1e-2), its plain and SDPA times and bound at
    the probe's first shape. Returns (the probe's launches, P1's JSON row,
    P1's max_abs_err to its plain version)."""
    import torch.nn.functional as F

    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.scripts.exp2_probe import SHAPES, probe

    print(f"== exp2 probe on {card}: blockwise_fwd_exp2 (P1, exp2 with log2 e folded "
          f"into the scale) against blockwise_fwd (expf), bf16", flush=True)
    kernels.launches.clear()  # the probe's run starts here
    rows = probe()
    launches = dict(kernels.launches)  # ... and ends here
    for row in rows:
        exp_ms, exp2_ms = min(row["exp_ms"]), min(row["exp2_ms"])
        print(f"  {row['shape']}: exp {row['exp_ms'][0]:.4f} / {row['exp_ms'][1]:.4f} ms, "
              f"exp2 {row['exp2_ms'][0]:.4f} / {row['exp2_ms'][1]:.4f} ms, exp2/exp "
              f"{exp2_ms / exp_ms:.3f}; P1 against B2 max_abs_err "
              f"{row['max_abs_err']:.3e} (atol/rtol 3e-2)", flush=True)
    print(f"  launches: {launches}", flush=True)
    b, h, n, d = SHAPES[0]
    q, k, v = heads_qkv(b, h, n, d, torch.bfloat16, seed=960)
    scale = 1.0 / d ** 0.5
    out, lse = fb.blockwise_attention_fwd_exp2(q, k, v, scale)
    ref, ref_lse = fb.blockwise_attention_exp2_reference(q, k, v, scale, fb.KERNEL_BLOCK_K)
    ok, tol = forward_ok(torch, out, ref, "bfloat16")
    lse_err = rel_err(lse, ref_lse)
    err = max_abs(out, ref)
    print(f"  {fb.KERNEL_EXP2} ({b},{h},{n},{d}) against its plain version at block_k "
          f"{fb.KERNEL_BLOCK_K}: max_abs_err {err:.3e} ({tol}); lse rel_err "
          f"{lse_err:.3e} (<= {LSE_REL_TOL:g}) {'ok' if ok else 'MISS'}", flush=True)
    if not ok or lse_err > LSE_REL_TOL:
        fail("P1 disagrees with its plain version")
    plain_ms = cuda_ms(lambda: fb.blockwise_attention_exp2_reference(
        q, k, v, scale, fb.KERNEL_BLOCK_K), iters=10)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
    bound_ms, bound_by = blockwise_bounds(b, h, n, d, "bfloat16")["fwd"]
    print(f"  {fb.KERNEL_EXP2} ({b},{h},{n},{d}): plain {plain_ms:.4f} ms, SDPA "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    stats = {"ms": min(rows[0]["exp2_ms"]), "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": library_ms, "shape": list(SHAPES[0]),
             "blockwise_fwd_same_shape_ms": min(rows[0]["exp_ms"])}
    return launches, stats, err


# -- fault tolerance, the scanned stack, V-MoE and patch dropout ------------

# the preempt phase's fault lands mid-epoch 2 of the DINO trainer's run: 9
# train steps an epoch, so after 13 steps, at epoch 2 batch 4
PREEMPT_STEP = 13
PREEMPT_OVERRIDES = ["training.num_epochs=2", "eval.interval=0",
                     f"training.fault_inject_preempt_step={PREEMPT_STEP}",
                     "training.auto_resume=true"]


def phase_preempt(torch, fa, card, tmp, straight):
    """DINO ViT-S/8 (configs/dino.yaml) through the CLI's own flow
    (``train.__main__.fit_with_preemption``) over the DINO trainer phase's
    in-memory images: with PREEMPT_OVERRIDES the fit stops at epoch 2 after
    4 batches and exits 75, preempt_model's metadata says so; the same call
    again auto-resumes, trains the epoch's other 5 batches, removes
    preempt_model, and its last_model equals the trainer phase's straight
    fit(2) (``straight``) bit for bit: student, teacher, center, AdamW count
    and moments, step. Prints save_preempt's snapshot and write. Returns the
    launches of both runs."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.config import compose, validate_train_config
    from vit_ssl_tpu_torch.data.builder import make_loaders
    from vit_ssl_tpu_torch.models.builder import build_dino_network
    from vit_ssl_tpu_torch.train.__main__ import fit_with_preemption, get_trainer
    from vit_ssl_tpu_torch.utils.checkpoint import load_checkpoint
    from vit_ssl_tpu_torch.utils.preempt import PREEMPT_EXIT_CODE

    configs = Path(__file__).resolve().parent / "configs"
    run_dir = str(Path(tmp) / "preempt")
    config = compose(configs, "dino", PREEMPT_OVERRIDES + [f"hydra.run.dir={run_dir}"])
    validate_train_config(config)
    print(f"== preempt: configs/dino.yaml with {' '.join(PREEMPT_OVERRIDES)} through "
          f"train.__main__.fit_with_preemption over the DINO trainer's {TRAINER_IMAGES} "
          f"in-memory images, then the same call again; {card}", flush=True)
    images = np.random.default_rng(5).integers(
        0, 256, (TRAINER_IMAGES, 96, 96, 3), dtype=np.uint8)

    def run(label):
        train_loader, val_loader = make_loaders(config, InMemoryImages(images))
        trainer = get_trainer("dino", build_dino_network(config, "cuda"), run_dir, config,
                              train_loader, val_loader, "cuda")
        log, code = [], None
        trainer.train_step = counted_steps(trainer.train_step, log)
        with no_plain_attention(fa):
            kernels.launches.clear()  # this run's path starts here
            try:
                fit_with_preemption(trainer, config, run_dir)
            except SystemExit as e:
                code = e.code
            launches = dict(kernels.launches)  # ... and ends here
        for i, (_, got, _) in enumerate(log):
            if got != attention_launches(fa):
                fail(f"{label} train step {i} launched {got}")
        return trainer, len(log), code, launches

    t0 = time.perf_counter()
    trainer, steps, code, first = run("the preempted run")
    first_s = time.perf_counter() - t0
    meta_path = Path(run_dir) / "preempt_model" / "metadata.json"
    if code != PREEMPT_EXIT_CODE or not meta_path.exists():
        fail(f"the preempted run ended with {code} and preempt_model "
             f"{'written' if meta_path.exists() else 'missing'}")
    meta = json.loads(meta_path.read_text())
    want = (1, 2, PREEMPT_STEP - 9)
    got = (meta["epoch"], meta["preempt_epoch"], meta["preempt_batches_done"])
    if got != want or steps != PREEMPT_STEP:
        fail(f"preempt_model's (epoch, preempt_epoch, preempt_batches_done) {got}, "
             f"expected {want}, after {steps} steps")
    save = trainer.save_times[-1]
    print(f"  preempted run: {steps} train steps, SystemExit({code}) in {first_s:.3f} s; "
          f"preempt_model epoch {got[0]}, preempt_epoch {got[1]}, batches done {got[2]}; "
          f"launches {first}", flush=True)
    print(f"  save_preempt on {card}: host snapshot {save['snapshot_ms']:.1f} ms, "
          f"synchronous write {save['write_s']:.3f} s", flush=True)
    del trainer
    t0 = time.perf_counter()
    resumed, steps, code, second = run("the auto-resumed run")
    if code is not None or steps != 18 - PREEMPT_STEP:
        fail(f"the auto-resumed run ended with {code} after {steps} steps")
    if (Path(run_dir) / "preempt_model").exists():
        fail("the auto-resumed run left preempt_model behind")
    got_tree, got_meta = load_checkpoint(str(Path(run_dir) / "last_model"))
    mismatch = state_mismatch(torch, got_tree, straight)
    if mismatch or got_meta["epoch"] != 2:
        fail(f"the preempted and auto-resumed run's last_model differs from the straight "
             f"fit(2) at {mismatch} (epoch {got_meta['epoch']})")
    print(f"  auto-resumed run: {steps} train steps in {time.perf_counter() - t0:.3f} s, "
          f"preempt_model removed; last_model bit-equal to the DINO trainer's straight "
          f"fit(2) (student, teacher, center, AdamW count and moments, step "
          f"{got_tree['step']}); launches {second}", flush=True)
    del resumed
    gc.collect()
    return {"preempt": first, "preempt_resumed": second}


# The data-parallel phase: configs/dino.yaml with ZeRO-3 sharding, in an
# NCCL process group of one rank (the machine has one card); eval.interval 0
# (the evaluations leave the trained state as it is: the trainer phase
# checks that bit for bit)
DP_OVERRIDES = ["training.num_epochs=2", "eval.interval=0", "parallel.fsdp=true"]
# NCCL's kernels carry this in their names
NCCL_KERNEL = "nccl"


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def state_close(torch, got, want, where="state"):
    """The paths where two checkpoint trees differ beyond the trainer's bars
    (each tensor's max |got - want| within GRAD_REL_TOL["bfloat16"] of
    max|want|, floored at 1e-6), and the largest such relative error."""
    if isinstance(want, torch.Tensor):
        err = max_abs(got, want) / max(float(want.float().abs().max()), 1e-6)
        return ([] if err <= GRAD_REL_TOL["bfloat16"] else [where]), err
    if isinstance(want, dict):
        items = want.items()
    elif isinstance(want, list):
        items = enumerate(want)
    else:
        return ([] if got == want else [where]), 0.0
    bad, worst = [], 0.0
    for key, value in items:
        b, e = state_close(torch, got[key], value, f"{where}.{key}")
        bad, worst = bad + b, max(worst, e)
    return bad, worst


def phase_data_parallel(torch, fa, card, tmp, straight, trainer_stats):
    """DINO ViT-S/8 (configs/dino.yaml with DP_OVERRIDES: parallel.fsdp) in
    an NCCL process group of world size 1 started here (a TCP store on a
    free port): the port's mesh published, the DINO trainer phase's
    in-memory images through the loaders, ``fit(2)`` with every gradient
    reduced (one reduce-scatter into the chunks, one all-reduce of the
    replicated leaves), the weight sums, center and statistics all-reduced,
    the parameters gathered for each step and freed after. Its last_model
    against the trainer phase's straight fit(2) (``straight``): bit-equal,
    or within the trainer's bars. One profile window of 3 train steps
    counts NCCL's kernels and B1's. Prints the in-loop step beside the
    straight trainer's and the peak memory; the group is destroyed at the
    end. Returns the path's launches and the phase's numbers."""
    import torch.distributed as dist

    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.config import compose, to_container, validate_train_config
    from vit_ssl_tpu_torch.data.builder import make_loaders
    from vit_ssl_tpu_torch.models.builder import build_dino_network
    from vit_ssl_tpu_torch.parallel import context as parallel_context
    from vit_ssl_tpu_torch.parallel.fsdp import ShardedState
    from vit_ssl_tpu_torch.parallel.mesh import mesh_from_config
    from vit_ssl_tpu_torch.train.__main__ import get_trainer
    from vit_ssl_tpu_torch.utils.checkpoint import load_checkpoint

    configs = Path(__file__).resolve().parent / "configs"
    run_dir = str(Path(tmp) / "data_parallel")
    config = compose(configs, "dino", DP_OVERRIDES + [f"hydra.run.dir={run_dir}"])
    validate_train_config(config)
    composed = to_container(config)
    plain = to_container(compose(configs, "dino"))
    diffs = config_differences(DINO_VIT_S8, plain)
    for key in ("model", "data", "transforms"):
        if composed[key] != plain[key]:
            diffs.append(f"the overrides changed config.{key}")
    if composed["parallel"] != dict(plain["parallel"], fsdp=True):
        diffs.append("the overrides changed config.parallel beyond fsdp")
    if diffs:
        fail("the data-parallel phase's config is not configs/dino.yaml with "
             "parallel.fsdp=true: " + "; ".join(diffs))
    port = free_port()
    print(f"== data parallel: configs/dino.yaml with {' '.join(DP_OVERRIDES)}, an NCCL "
          f"process group of 1 rank (TCP store on 127.0.0.1:{port}), fit(2) over the "
          f"DINO trainer's {TRAINER_IMAGES} in-memory images; {card}", flush=True)
    store = dist.TCPStore("127.0.0.1", port, 1, True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = mesh_from_config(config)
        parallel_context.set_parallel_context(mesh)
        images = np.random.default_rng(5).integers(
            0, 256, (TRAINER_IMAGES, 96, 96, 3), dtype=np.uint8)
        train_loader, val_loader = make_loaders(config, InMemoryImages(images))
        trainer = get_trainer("dino", build_dino_network(config, "cuda"), run_dir, config,
                              train_loader, val_loader, "cuda")
        if not isinstance(trainer._sharded, ShardedState) or trainer.mesh is not mesh:
            fail("the trainer did not take the published mesh and shard its state")
        at_rest = trainer._sharded.bytes_at_rest()
        print(f"  mesh {mesh}, backend {dist.get_backend()}; fsdp bytes at rest per "
              f"rank: {at_rest}", flush=True)
        log = []
        trainer.train_step = counted_steps(trainer.train_step, log)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with no_plain_attention(fa):
            kernels.launches.clear()  # the data-parallel path starts here
            trainer.fit(2)
            launches = dict(kernels.launches)  # ... and ends here
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if len(log) != 18 or trainer.state.step != 18:
            fail(f"the data-parallel fit(2) ran {len(log)} steps to step "
                 f"{trainer.state.step}, expected 18")
        for i, (_, got, _) in enumerate(log):
            if got != attention_launches(fa):
                fail(f"data-parallel train step {i} launched {got}")
        got_tree, meta = load_checkpoint(str(Path(run_dir) / "last_model"))
        mismatch = state_mismatch(torch, got_tree, straight)
        bad, worst = state_close(torch, got_tree, straight)
        if bad or meta["epoch"] != 2:
            fail(f"the data-parallel last_model differs from the straight fit(2) beyond "
                 f"the trainer's bars at {bad[:5]} (worst rel err {worst:.3e}; epoch "
                 f"{meta['epoch']})")
        print(f"  last_model against the DINO trainer's straight fit(2): "
              + ("bit-equal (student, teacher, center, AdamW count and moments, step)"
                 if mismatch is None else
                 f"not bit-equal (first at {mismatch}), worst rel err {worst:.3e} "
                 f"(<= {GRAD_REL_TOL['bfloat16']:g})"), flush=True)
        step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(log[9:], log[10:])]
        stats = {"step_ms_median": float(np.median(step_ms)), "peak_gb": peak_gb,
                 "bit_equal": mismatch is None, "worst_rel_err": worst,
                 "bytes_at_rest": at_rest,
                 "straight_step_ms_median": trainer_stats["step_ms_median"],
                 "straight_peak_gb": trainer_stats["peak_gb"]}
        print(f"  in-loop step (epoch 2, median of {len(step_ms)} intervals) "
              f"{stats['step_ms_median']:.3f} ms against the straight trainer's "
              f"{trainer_stats['step_ms_median']:.3f} ms; peak memory {peak_gb:.2f} GB "
              f"against {trainer_stats['peak_gb']:.2f} GB", flush=True)

        batch = trainer._put(next(iter(train_loader)))
        t_temp, t_momentum = trainer._teacher_temp(3), trainer._teacher_momentum(3)

        def three_steps():
            for _ in range(3):
                trainer.train_step(trainer.state, batch, t_temp, t_momentum)

        report = {}
        backward = fa.BACKWARD_BODIES[fa.attention_nhd_bwd_form(TRAIN_CASES[0][1], 0,
                                                                torch.bfloat16)]
        with no_plain_attention(fa):
            profile_window(torch, three_steps, "3 data-parallel training steps", rows=30,
                           want=(NCCL_KERNEL, *backward),
                           counts={name: 3 * attention_launches(fa)[fa.KERNEL_BWD]
                                   for name in backward}, report=report)
        counts = report["device_counts"]
        nccl = {k: v for k, v in counts.items() if NCCL_KERNEL in k.lower()}
        copies = {k: v for k, v in counts.items() if k.startswith("Memcpy DtoD")}
        b1 = {k: v for k, v in counts.items()
              if any(body in k for body in (*backward, *fa.FORWARD_BODIES.values()))}
        if not nccl or not b1:
            fail(f"the data-parallel window counted NCCL kernels {nccl} and B1 {b1}")
        stats["window_nccl_kernels"], stats["window_b1_kernels"] = nccl, b1
        stats["window_device_copies"] = copies
        print(f"  in the window of 3 steps: NCCL's device operations {nccl} "
              f"({sum(nccl.values())}; at one rank NCCL copies where several run its "
              f"ring kernels), device-to-device copies {copies}; B1's kernels "
              f"{sum(b1.values())} launches {b1}", flush=True)
        del trainer, batch
    finally:
        parallel_context.set_parallel_context(None)
        dist.destroy_process_group()
    gc.collect()
    return {"data_parallel": launches}, stats


# The ring phase: ViT-B/16's 512-px attention as sp = RING_SP virtual ranks
RING_CASE = (64, 12, 1025, 64, "bfloat16")
RING_SP = 5


def phase_ring(torch, fb, card):
    """Ring attention's per-rank body (``parallel/ring_attention.py``) over
    RING_SP virtual ranks in this process (the rotation an index shift) at
    RING_CASE: the forward and backward through B2 (sp² forwards, sp² dq
    and sp² dk/dv launches, counted), held against B2 on the whole
    sequence and against the plain version with the B2 rows' bars (o by
    :func:`forward_ok`, lse within LSE_REL_TOL, each gradient within
    GRAD_REL_TOL floored as B2_GRAD_FLOOR says). Prints the ring's time
    beside B2's on the whole sequence. Returns the path's launches and the
    numbers."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.parallel.ring_attention import (virtual_ring_backward,
                                                           virtual_ring_forward)

    b, h, n, d, dtype_name = RING_CASE
    sp = RING_SP
    if n % sp:
        fail(f"the ring's N = {n} is not divisible by sp = {sp}")
    print(f"== ring: ({b},{h},{n},{d}) {dtype_name} as sp = {sp} virtual ranks of "
          f"{n // sp} tokens, every hop through B2; {card}", flush=True)
    q, k, v, do = heads_qkv(b, h, n, d, getattr(torch, dtype_name), seed=1200, count=4)
    scale = 1.0 / d ** 0.5
    torch.cuda.synchronize()
    kernels.launches.clear()  # the ring's path starts here
    o, lse = virtual_ring_forward(q, k, v, scale, sp)
    grads = virtual_ring_backward(q, k, v, o, lse, do, scale, sp)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)  # ... and ends here
    want = {fb.KERNEL: sp * sp, fb.KERNEL_DQ: sp * sp, fb.KERNEL_DKV: sp * sp}
    if launches != want:
        fail(f"the ring launched {launches}, expected {want}")
    whole_o, whole_lse = fb.blockwise_attention_fwd(q, k, v, scale)
    whole = fb.blockwise_attention_bwd(q, k, v, whole_o, whole_lse, do, scale)
    ref_o, ref_lse = fb.blockwise_attention_reference(q, k, v, scale, fb.KERNEL_BLOCK_K)
    ref = fb.blockwise_attention_bwd_reference(q, k, v, ref_o, ref_lse, do, scale)
    torch.cuda.synchronize()
    tol = GRAD_REL_TOL[dtype_name]
    errs = {}
    for label, (o_w, lse_w, g_w) in (("B2 on the whole sequence", (whole_o, whole_lse, whole)),
                                      ("the plain version", (ref_o, ref_lse, ref))):
        fwd_ok, fwd_tol = forward_ok(torch, o, o_w, dtype_name)
        lse_err = rel_err(lse, lse_w)
        rel = b2_grad_errs(q, k, v, do, scale, grads, g_w)
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        ok = fwd_ok and lse_err <= LSE_REL_TOL and max(rel) <= tol and finite
        print(f"  against {label}: o max_abs_err {max_abs(o, o_w):.3e} ({fwd_tol}), lse "
              f"rel_err {lse_err:.3e} (<= {LSE_REL_TOL:g}), dq/dk/dv rel_err "
              + "/".join(f"{e:.3e}" for e in rel) + f" (<= {tol:g}, floored) "
              + ("ok" if ok else "MISS"), flush=True)
        if not ok:
            fail(f"the ring disagrees with {label}")
        errs[label] = {"o": max_abs(o, o_w), "lse_rel": lse_err, "grads_rel": rel,
                       "grads_abs": [max_abs(g, w) for g, w in zip(grads, g_w)]}
    del whole, ref, ref_o, ref_lse
    ring_fwd = cuda_ms(lambda: virtual_ring_forward(q, k, v, scale, sp), iters=5, warmup=1)
    ring_bwd = cuda_ms(lambda: virtual_ring_backward(q, k, v, o, lse, do, scale, sp),
                       iters=5, warmup=1)
    whole_fwd = cuda_ms(lambda: fb.blockwise_attention_fwd(q, k, v, scale), iters=10)
    whole_bwd = cuda_ms(lambda: fb.blockwise_attention_bwd(q, k, v, whole_o, whole_lse,
                                                           do, scale), iters=10)
    stats = {"sp": sp, "ring_fwd_ms": ring_fwd, "ring_bwd_ms": ring_bwd,
             "whole_fwd_ms": whole_fwd, "whole_bwd_ms": whole_bwd, "errors": errs}
    print(f"  ring over {sp} virtual ranks (all hops and merges in one process): forward "
          f"{ring_fwd:.4f} ms, backward {ring_bwd:.4f} ms; B2 on the whole sequence: "
          f"forward {whole_fwd:.4f} ms, backward {whole_bwd:.4f} ms", flush=True)
    del q, k, v, do, o, lse, grads, whole_o, whole_lse
    gc.collect()
    return {"ring": launches}, stats


# Tensor and expert parallelism on the one card: the layers' per-rank bodies
# (vit_ssl_tpu_torch/parallel/tensor_parallel.py) over virtual ranks in this
# process, each held to the unsharded layer from the same parameters, inputs
# and dropout draws (NCCL puts no two ranks on one device)
TP_VIRTUAL = 2
EP_VIRTUAL = 4
TP_OUT_COSINE = 0.999  # each output row (PERF.md section 2's serving bar)
TP_GRAD_COSINE = 0.99  # every gradient (the training bar)
# the V-MoE block of MOE_OVERRIDES: 8 experts, top-2, routed per image
TP_MOE = {"num_experts": 8, "moe_top_k": 2, "moe_capacity_factor": 1.25,
          "moe_group_size": 197}


def cosine(a, b) -> float:
    """Cosine of two tensors taken whole (1 where both are zero)."""
    a, b = a.detach().float().reshape(-1), b.detach().float().reshape(-1)
    norms = float(a.norm() * b.norm())
    return 1.0 if norms == 0.0 and not bool(a.any()) and not bool(b.any()) \
        else float(a @ b) / max(norms, 1e-30)


def min_row_cosine(a, b) -> float:
    """The smallest cosine between matching rows (the last dim) of two tensors."""
    a = a.detach().float().reshape(-1, a.shape[-1])
    b = b.detach().float().reshape(-1, b.shape[-1])
    return float(((a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1)).clamp_min(1e-30)).min())


def tp_case(torch, label, module, call, x, sizes, want, guards, residual=False):
    """``call(module, x, generator)``'s output and gradients (x's and every
    parameter's, against a seeded cotangent) unsharded, then with the
    module's per-rank bodies over the virtual ranks of ``sizes``
    (``virtual_shards``), under ``guards``: the output within TP_OUT_COSINE
    a row, every gradient within TP_GRAD_COSINE, and the kernels the virtual
    run launched, counted, exactly ``want``. A ``residual`` block is held on
    its branches alone: its output less x, x's gradient less the cotangent
    (the identity path, which both ways share, would hide an error in the
    branches). Both ways' forward and backward timed. Returns (launches,
    stats)."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.parallel.tensor_parallel import virtual_shards

    params = list(module.parameters())
    with torch.no_grad():
        out = call(module, x, torch.Generator(device="cuda").manual_seed(41))
    cot = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(42),
                      device="cuda").to(out.dtype)

    def step():
        xg = x.detach().requires_grad_()
        out = call(module, xg, torch.Generator(device="cuda").manual_seed(41))
        return out, torch.autograd.grad(out, [xg] + params, cot)

    want_out, want_grads = step()
    whole_ms = cuda_ms(step, iters=5, warmup=1)
    with contextlib.ExitStack() as stack:
        for guard in guards:
            stack.enter_context(guard)
        plan = stack.enter_context(virtual_shards(module, sizes))
        torch.cuda.synchronize()
        kernels.launches.clear()  # the sharded path starts here
        got_out, got_grads = step()
        torch.cuda.synchronize()
        launches = dict(kernels.launches)  # ... and ends here
        virtual_ms = cuda_ms(step, iters=5, warmup=1)
    if residual:
        got_out, want_out = (o.float() - x.float() for o in (got_out, want_out))
        got_grads, want_grads = ([g[0].float() - cot.float(), *g[1:]]
                                 for g in (got_grads, want_grads))
    out_cos = min_row_cosine(got_out, want_out)
    grad_cos = [cosine(g, w) for g, w in zip(got_grads, want_grads)]
    finite = bool(torch.isfinite(got_out).all()) and all(
        bool(torch.isfinite(g).all()) for g in got_grads)
    ok = (launches == want and out_cos >= TP_OUT_COSINE and min(grad_cos) >= TP_GRAD_COSINE
          and finite)
    held = "branch output" if residual else "output"
    print(f"  {label}: {len(plan)} tensors sharded over {sizes}; launched {launches}; "
          f"{held} row cosine min {out_cos:.6f} (>= {TP_OUT_COSINE}), {len(grad_cos)} "
          f"gradients' cosine min {min(grad_cos):.6f} (>= {TP_GRAD_COSINE}); forward and "
          f"backward {virtual_ms:.3f} ms over the virtual ranks against {whole_ms:.3f} ms "
          f"unsharded {'ok' if ok else 'MISS'}", flush=True)
    if not ok:
        fail(f"{label}: the sharded layer launched {launches} (expected {want}) or "
             "disagrees with the unsharded layer")
    return launches, {"sizes": sizes, "launches": launches, "held": held,
                      "out_row_cosine_min": out_cos,
                      "grad_cosine_min": min(grad_cos), "virtual_ms": virtual_ms,
                      "unsharded_ms": whole_ms}


def phase_tensor_parallel(torch, fa, fb, fm, card):
    """The per-rank bodies over virtual ranks, each against the unsharded
    layer (:func:`tp_case`; a block on its branches), bf16 at full width: DINO ViT-S/8's encoder
    block, unfused and fused, at the student's globals (256, 145) and packed
    locals (128, 148, block 37), and its head, at tp = TP_VIRTUAL; one
    ViT-B/16 block at 384 px (B3) and at 512 px (B2) at tp = TP_VIRTUAL; one
    V-MoE ViT-B/16 MoE block at ep = EP_VIRTUAL. Every kernel runs at the
    local shapes (3 or 6 heads a rank, d_ff 768 a rank), no plain version
    allowed. Returns (launches by path, stats by path)."""
    from vit_ssl_tpu_torch.models.dino import DINOHead
    from vit_ssl_tpu_torch.ops.encoder_block import EncoderBlock

    dino, vit_b = DINO_VIT_S8["model"], VIT_B16_384["model"]
    tp, ep = {"model": TP_VIRTUAL}, {"expert": EP_VIRTUAL}
    print(f"== tensor and expert parallel: the layers' per-rank bodies over virtual "
          f"ranks (tp = {TP_VIRTUAL}, ep = {EP_VIRTUAL}) against the unsharded layers; "
          f"{card}", flush=True)
    guards = lambda: (no_plain_attention(fa), no_plain_mlp(fm))  # noqa: E731

    def block(model, seed, fused=False, **kw):
        torch.manual_seed(seed)
        return EncoderBlock(model["embed_dim"], model["num_heads"], model["mlp_dim"],
                            dtype=torch.bfloat16, dropout=model["dropout"],
                            use_fused_mlp=fused, **kw).cuda()

    def tokens(b, n, d, seed):
        return torch.randn(b, n, d, generator=torch.Generator().manual_seed(seed)) \
            .to(device="cuda", dtype=torch.bfloat16)

    def through(bs=0, **kw):
        return lambda m, x, g: m(x, bs, False, g, **kw)

    b1 = {fa.KERNEL_TRAIN: TP_VIRTUAL, fa.KERNEL_BWD: TP_VIRTUAL}
    b4 = {fm.KERNEL_TRAIN: TP_VIRTUAL, fm.KERNEL_BWD: TP_VIRTUAL}
    d = dino["embed_dim"]
    cases = []
    for fused in (False, True):
        net = block(dino, 1500, fused)
        for where, x, bs in (("globals", tokens(256, 145, d, 1501), 0),
                             ("packed", tokens(128, 148, d, 1502), 37)):
            cases.append((f"tp_dino_block{'_fused' if fused else ''}_{where}",
                          f"DINO ViT-S/8 block{' (fused)' if fused else ''}, {where} "
                          f"{tuple(x.shape[:2])}{f' block {bs}' if bs else ''}",
                          net, through(bs), x, tp, {**b1, **(b4 if fused else {})}, True))
    torch.manual_seed(1503)
    head = DINOHead(d, dino["output_dim"], dtype=torch.bfloat16).reset_parameters(
        torch.Generator().manual_seed(1504)).cuda()
    cases.append(("tp_dino_head", f"DINO head {d} -> 2048 -> 2048 -> {d} -> "
                  f"{dino['output_dim']}", head, lambda m, x, g: m(x),
                  tokens(1, 256, d, 1505)[0], tp, {}, False))
    vit = block(vit_b, 1506)
    cases += [
        ("tp_vit_b_384", "ViT-B/16 block at 384 px (64, 577)", vit, through(),
         tokens(64, 577, vit_b["embed_dim"], 1507), tp,
         {fa.FUSED_KERNEL_TRAIN: TP_VIRTUAL, fa.FUSED_KERNEL_BWD: TP_VIRTUAL}, True),
        ("tp_vit_b_512", "ViT-B/16 block at 512 px (64, 1025)", vit, through(),
         tokens(64, 1025, vit_b["embed_dim"], 1508), tp,
         {fb.KERNEL: TP_VIRTUAL, fb.KERNEL_DQ: TP_VIRTUAL, fb.KERNEL_DKV: TP_VIRTUAL}, True),
        ("ep_vmoe_block", "V-MoE ViT-B/16 MoE block (64, 197), 8 experts, top-2",
         block(vit_b, 1509, **TP_MOE), lambda m, x, g: m(x, 0, False, g, return_aux=True)[0],
         tokens(64, 197, vit_b["embed_dim"], 1510), ep,
         {fa.KERNEL_TRAIN: 1, fa.KERNEL_BWD: 1}, True),
    ]
    paths, stats = {}, {}
    for name, label, module, call, x, sizes, want, residual in cases:
        paths[name], stats[name] = tp_case(torch, label, module, call, x, sizes, want,
                                           guards(), residual)
    del cases, net, head, vit
    gc.collect()
    return paths, stats


def phase_tp_times(torch, fa, fb, fm, card, errors):
    """Each kernel of the tensor-parallel phase at one rank's local shape at
    tp = TP_VIRTUAL, bf16, with its max_abs_err from the kernel checks
    (``errors``: B1's, B4's, B3's and B2's by case): B1's training forward
    and backward at TP_B1_CASES' DINO shapes, (256, 145, 3 x 64) and (128,
    148, 3 x 64, block 37); B4's training forward and backward at
    TP_B4_CASES (384 -> 768); B3's training entries at TP_B3_CASE; B2's at
    TP_B2_CASE (:func:`heads_time_rows`). Returns {kernel: [rows]}."""
    print(f"== kernel times at the tp = {TP_VIRTUAL} local shapes on {card} (bf16)",
          flush=True)
    rows = {}
    for idx, case in enumerate(TP_B1_CASES[:2]):
        b, n, h, d, dtype_name, bs = case
        xq, xk, xv = qkv(b, n, h, d, torch.bfloat16, seed=1520 + idx)
        (do,) = qkv(b, n, h, d, torch.bfloat16, seed=1530 + idx)[:1]
        scale = 1.0 / d ** 0.5
        bounds = attention_train_bounds(b, n, h, d, dtype_name, bs)
        out_err, grad_err = errors["b1"][case]
        rows.setdefault(fa.KERNEL_TRAIN, []).append({**b1_forward_row(
            torch, fa, fa.KERNEL_TRAIN, f", tp = {TP_VIRTUAL} local heads", xq, xk, xv,
            h, scale, bs, bounds["fwd"]), "max_abs_err": out_err})
        rows.setdefault(fa.KERNEL_BWD, []).append({**b1_backward_row(
            torch, fa, xq, xk, xv, do, h, scale, bs, bounds["bwd"]), "max_abs_err": grad_err})
    for t, d_model, d_ff in TP_B4_CASES:
        errs = errors["b4"][(t, d_model, d_ff, "bfloat16")]
        for part, name, err in (("fwd_pre", fm.KERNEL_TRAIN, errs["fwd_pre"]),
                                ("bwd", fm.KERNEL_BWD, errs["bwd_abs"]["dx"])):
            rows.setdefault(name, []).append({**mlp_time_row(
                torch, fm, part, t, True, (d_model, d_ff), profile=False), "max_abs_err": err})
    for route, case, seed in (("B3", TP_B3_CASE, 1522), ("B2", TP_B2_CASE, 1523)):
        b, h, n, d, dtype_name = case
        q, k, v, do = heads_qkv(b, h, n, d, getattr(torch, dtype_name), seed=seed, count=4)
        timed, _ = heads_time_rows(torch, fa, fb, route, q, k, v, do)
        if route == "B3":
            out_err, grad_err = errors["b3"][case]
            named = {fa.FUSED_KERNEL_TRAIN: (timed["fwd_stats"], out_err),
                     fa.FUSED_KERNEL_BWD: (timed["bwd"], grad_err)}
        else:
            errs = errors["b2"][case]
            named = {fb.KERNEL: (timed["fwd"], errs["fwd"]),
                     fb.KERNEL_DQ: (timed["dq"], errs["dq"]),
                     fb.KERNEL_DKV: (timed["dkv"], errs["dkv"])}
        for name, (row, err) in named.items():
            rows.setdefault(name, []).append({**row, "max_abs_err": err})
        del q, k, v, do
    gc.collect()
    return rows


PIPE_ROW_COSINE = 0.9999  # each output row against the unpipelined stack
PIPE_GRAD_COSINE = 0.999  # every parameter's and the input's gradient


def pipe_case(torch, label, blocks, x, block_size, pp, m, v, want, guards):
    """The encoder ``blocks`` over ``x`` (dropout 0) and the gradients of
    its output against a seeded cotangent (x's and every parameter's):
    unpipelined (the blocks in order), then over ``pp`` virtual stages
    (``m`` microbatches, ``v`` chunks a stage: the per-stage bodies the
    gloo ranks run, :class:`~vit_ssl_tpu_torch.parallel.pipeline.Pipeline`)
    under ``guards``: each output row within PIPE_ROW_COSINE, every
    gradient within PIPE_GRAD_COSINE, and the kernels the pipelined run
    launched, counted, exactly ``want``. Both ways timed (forward and
    backward). Returns (launches, stats)."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.parallel.pipeline import Pipeline, pipeline_bubble_fraction

    params = list(blocks.parameters())
    pipe = Pipeline(len(blocks), pp, m, v)
    with torch.no_grad():
        probe = x
        for block in blocks:
            probe = block(probe, block_size)
    cot = torch.randn(probe.shape, generator=torch.Generator(device=x.device)
                      .manual_seed(43), device=x.device).to(probe.dtype)
    del probe

    def unpipelined():
        h = xg = x.detach().requires_grad_()
        for block in blocks:
            h = block(h, block_size, False)
        return h, torch.autograd.grad(h, [xg] + params, cot)

    def pipelined():
        xg = x.detach().requires_grad_()
        h = pipe(blocks, xg, block_size, False)
        return h, torch.autograd.grad(h, [xg] + params, cot)

    want_out, want_grads = unpipelined()
    whole_ms = cuda_ms(unpipelined, iters=3, warmup=1)
    with contextlib.ExitStack() as stack:
        for guard in guards:
            stack.enter_context(guard)
        torch.cuda.synchronize()
        kernels.launches.clear()  # the pipelined path starts here
        got_out, got_grads = pipelined()
        torch.cuda.synchronize()
        launches = dict(kernels.launches)  # ... and ends here
        pipe_ms = cuda_ms(pipelined, iters=3, warmup=1)
    out_cos = min_row_cosine(got_out, want_out)
    grad_cos = [cosine(g, w) for g, w in zip(got_grads, want_grads)]
    finite = bool(torch.isfinite(got_out).all()) and all(
        bool(torch.isfinite(g).all()) for g in got_grads)
    ok = (launches == want and out_cos >= PIPE_ROW_COSINE
          and min(grad_cos) >= PIPE_GRAD_COSINE and finite)
    bubble = pipeline_bubble_fraction(pp, m, v)
    print(f"  {label}: pp = {pp}, M = {m}, V = {v} (bubble fraction {bubble:.3f}); "
          f"launched {launches}; output row cosine min {out_cos:.6f} (>= "
          f"{PIPE_ROW_COSINE}), {len(grad_cos)} gradients' cosine min {min(grad_cos):.6f} "
          f"(>= {PIPE_GRAD_COSINE}); forward and backward {pipe_ms:.3f} ms over the "
          f"virtual stages (in series) against {whole_ms:.3f} ms unpipelined "
          f"{'ok' if ok else 'MISS'}", flush=True)
    if not ok:
        fail(f"{label}: the pipelined stack launched {launches} (expected {want}) or "
             "disagrees with the unpipelined stack")
    return launches, {"pp": pp, "microbatches": m, "interleave": v,
                      "bubble_fraction": bubble, "launches": launches,
                      "out_row_cosine_min": out_cos, "grad_cosine_min": min(grad_cos),
                      "pipelined_ms": pipe_ms, "unpipelined_ms": whole_ms}


def phase_pipeline(torch, fa, fb, fm, card):
    """The pipeline's per-stage bodies over virtual stages in one process
    (one card holds one rank), at full width, bf16, dropout 0, each against
    the unpipelined stack on the same weights and inputs
    (:func:`pipe_case`): DINO ViT-S/8's student encoder (6 blocks of 6 x 64)
    at pp = 2, M = 2 on the globals (256, 145) and the packed locals (128,
    148, block 37), at pp = 3, V = 2, M = 4 (one block a chunk) on both, and
    at pp = 2 with the fused FFN (B4); ViT-B/16's encoder at 384 px, batch
    64 (B3), pp = 4, M = 4; at 512 px, batch 64 (B2), pp = 2, V = 2, M = 2.
    Every kernel runs at its microbatch shape, no plain version allowed.
    Returns (launches by path, stats by path)."""
    from vit_ssl_tpu_torch.ops.encoder_block import EncoderBlock

    dino, vit_b = DINO_VIT_S8["model"], VIT_B16_384["model"]
    print(f"== pipeline: the per-stage bodies over virtual stages against the "
          f"unpipelined encoder; {card}", flush=True)
    guards = lambda: (no_plain_attention(fa), no_plain_mlp(fm))  # noqa: E731

    def stack(model, seed, fused=False):
        torch.manual_seed(seed)
        return torch.nn.ModuleList(
            EncoderBlock(model["embed_dim"], model["num_heads"], model["mlp_dim"],
                         dtype=torch.bfloat16, dropout=0.0, use_fused_mlp=fused)
            for _ in range(model["num_blocks"])).cuda()

    def tokens(b, n, d, seed):
        return torch.randn(b, n, d, generator=torch.Generator().manual_seed(seed)) \
            .to(device="cuda", dtype=torch.bfloat16)

    def calls(kernel_names, blocks, m):
        """Each kernel once a block and microbatch."""
        return {name: len(blocks) * m for name in kernel_names}

    b1 = (fa.KERNEL_TRAIN, fa.KERNEL_BWD)
    b4 = (fm.KERNEL_TRAIN, fm.KERNEL_BWD)
    d = dino["embed_dim"]
    student = stack(dino, 1600)
    fused = stack(dino, 1600, fused=True)
    fused.load_state_dict(student.state_dict())
    globals_x, locals_x = tokens(256, 145, d, 1601), tokens(128, 148, d, 1602)
    cases = []
    for where, x, bs in (("globals", globals_x, 0), ("packed", locals_x, 37)):
        shape = f"{tuple(x.shape[:2])}{f' block {bs}' if bs else ''}"
        cases += [
            (f"pp_dino_{where}", f"DINO ViT-S/8 student, {where} {shape}", student, x, bs,
             2, 2, 1, calls(b1, student, 2)),
            (f"pp_dino_{where}_interleaved", f"DINO ViT-S/8 student, {where} {shape}, "
             "interleaved", student, x, bs, 3, 4, 2, calls(b1, student, 4)),
        ]
    cases.append(("pp_dino_fused_globals", "DINO ViT-S/8 student (fused FFN), globals "
                  "(256, 145)", fused, globals_x, 0, 2, 2, 1, calls(b1 + b4, fused, 2)))
    paths, stats = {}, {}
    for name, label, blocks, x, bs, pp, m, v, want in cases:
        paths[name], stats[name] = pipe_case(torch, label, blocks, x, bs, pp, m, v, want,
                                             guards())
    del cases, student, fused, globals_x, locals_x
    gc.collect()
    width = vit_b["embed_dim"]
    for name, label, img_n, route, pp, m, v, seed in (
            ("pp_vit_b_384", "ViT-B/16 encoder at 384 px (64, 577)", 577,
             (fa.FUSED_KERNEL_TRAIN, fa.FUSED_KERNEL_BWD), 4, 4, 1, 1604),
            ("pp_vit_b_512", "ViT-B/16 encoder at 512 px (64, 1025)", 1025,
             (fb.KERNEL, fb.KERNEL_DQ, fb.KERNEL_DKV), 2, 2, 2, 1605)):
        blocks = stack(vit_b, seed)
        paths[name], stats[name] = pipe_case(
            torch, label, blocks, tokens(64, img_n, width, seed), 0, pp, m, v,
            calls(route, blocks, m), guards())
        del blocks
        gc.collect()
    torch.cuda.empty_cache()
    return paths, stats


def named_moments(state, names):
    """An optimizer state's AdamW moments by ``mu.<param>``/``nu.<param>``."""
    return {f"{b}.{n}": t for b in ("mu", "nu")
            for n, t in zip(names, state.opt_state.buffers[b])}


def phase_scan(torch, fa, card):
    """DINO ViT-S/8 with ``model.scan_layers=true``: the training phase's
    initial weights converted to the stacked layout (``flat_to_scanned``),
    one training step against the unrolled step from the same state and
    batch, bit for bit (loss, student, teacher, center, moments); the
    stacked state through ``state.pt`` and ``flat_to_unrolled`` loads
    strictly into an unrolled state and equals it; warm steps of both.
    Returns the scanned step's launches."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.models import build_dino_network
    from vit_ssl_tpu_torch.ops import encoder_stack as es
    from vit_ssl_tpu_torch.train import AdamW, TrainState
    from vit_ssl_tpu_torch.train.trainers.base import to_host
    from vit_ssl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    print(f"== scan: DINO ViT-S/8 train_step with model.scan_layers=true against the "
          f"unrolled step from one converted state, batch "
          f"{DINO_VIT_S8['training']['batch_size']}; {card}", flush=True)
    unrolled, train_step, batch = build_training(torch)
    cfg = copy.deepcopy(DINO_VIT_S8)
    cfg["model"]["scan_layers"] = True
    student = build_dino_network(cfg, "cuda")
    student.load_state_dict(es.flat_to_scanned(unrolled.student.state_dict()), strict=True)
    # the optimizer here only makes the zero moments: the step updates with
    # its own (build_training's)
    scanned = TrainState(student, AdamW(lambda step: 0.0), seed=unrolled.seed)
    if scanned.student.backbone.encoder_scan is None:
        fail("model.scan_layers built no stacked body")
    temps = schedule_values()
    with no_plain_attention(fa):
        want = train_step(unrolled, batch, *temps)
        kernels.launches.clear()  # the scanned step's path starts here
        got = train_step(scanned, batch, *temps)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)  # ... and ends here
    if launches != attention_launches(fa):
        fail(f"the scanned step launched {launches}, expected {attention_launches(fa)}")
    names_u = [n for n, _ in unrolled.student.named_parameters()]
    names_s = [n for n, _ in scanned.student.named_parameters()]
    pairs = [("loss", {"loss": got["loss"]}, {"loss": want["loss"]}),
             ("student", scanned.student.state_dict(),
              es.flat_to_scanned(unrolled.student.state_dict())),
             ("teacher", scanned.teacher.state_dict(),
              es.flat_to_scanned(unrolled.teacher.state_dict())),
             ("center", {"c": scanned.center}, {"c": unrolled.center}),
             ("moments", named_moments(scanned, names_s),
              es.flat_to_scanned(named_moments(unrolled, names_u)))]
    worst = {}
    for label, a, b in pairs:
        if set(a) != set(b):
            fail(f"scan: the {label} keys differ")
        worst[label] = max(float((a[k].float() - b[k].float()).abs().max()) for k in b)
    if any(worst.values()):
        fail(f"the scanned step is not bit-equal to the unrolled one: largest "
             f"differences {worst}")
    print(f"  one step: loss {float(got['loss']):.6f}; loss, student, teacher, center and "
          f"AdamW moments bit-equal to the unrolled step; launches {launches}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(str(Path(tmp) / "scan"), to_host(scanned.state_dict()), {})
        tree, _ = load_checkpoint(str(Path(tmp) / "scan"))
    moments = es.flat_to_unrolled(dict(zip(
        [f"{b}.{n}" for b in ("mu", "nu") for n in names_s],
        tree["opt_state"]["mu"] + tree["opt_state"]["nu"])))
    converted = {"step": tree["step"], "center": tree["center"],
                 "student": es.flat_to_unrolled(tree["student"]),
                 "teacher": es.flat_to_unrolled(tree["teacher"]),
                 "opt_state": {"count": tree["opt_state"]["count"],
                               **{b: [moments[f"{b}.{n}"] for n in names_u]
                                  for b in ("mu", "nu")}}}
    if not any(k.startswith("backbone.encoder_scan.block.") for k in tree["student"]):
        fail("the scanned state.pt holds no stacked tensors")
    fresh, _, _ = build_training(torch)
    fresh.load_state_dict(converted)  # strict
    mismatch = state_mismatch(torch, to_host(fresh.state_dict()),
                              to_host(unrolled.state_dict()))
    if mismatch:
        fail(f"the stacked state.pt converted back differs from the unrolled state at "
             f"{mismatch}")
    print("  the stacked state.pt (backbone.encoder_scan.block.*), converted with "
          "flat_to_unrolled, loads strictly into an unrolled TrainState bit-equal to "
          "the unrolled step's", flush=True)
    del fresh
    warm = {}
    for label, state in (("unrolled", unrolled), ("scanned", scanned)):
        host_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            train_step(state, batch, *temps)
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        warm[label] = float(np.median(host_ms))
    print(f"  warm step on {card}, median of 3, host clock with torch.cuda.synchronize(): "
          f"scanned {warm['scanned']:.3f} ms, unrolled {warm['unrolled']:.3f} ms "
          f"({warm['scanned'] / warm['unrolled']:.3f}x; a finding, not a claim)",
          flush=True)
    del unrolled, scanned, batch
    gc.collect()
    return {"scan_step": launches}


# V-MoE-B/16 "every-2" (Riquelme et al., arXiv:2106.05974): configs/vit_b_imagenet.yaml
# with 8 experts, routed per image (197 tokens a group, capacity 64); the
# rest as written (top-2, moe_every 2: 6 MoE blocks, capacity factor 1.25,
# aux weight 0.01, z-loss 1e-3, remat, batch 1024, 224 px)
MOE_OVERRIDES = ["model.moe_experts=8", "model.moe_group_size=197"]
MOE_IMAGES = 2130  # 2045 train images (2 steps of 1024) and 85 val at val_split 0.04
# the kernel path's routing, each decision taken from the same upstream
# routing as an fp64-attention forward, agrees with fp64's at least as
# often as the plain attention path's does, to this share
ROUTING_FIDELITY_SLACK = 1e-3
VIT_B_DENSE_BUSY_MS = 670.65  # device busy of the dense step (PERF.md section 5)


@contextlib.contextmanager
def recorded_routing(log):
    """Record each routing call's top-k expert indices and its router loss
    (``aux_weight``·balance + ``zloss_weight``·z-loss at the config's
    weights) into ``log``."""
    from vit_ssl_tpu_torch.ops import moe as moe_mod

    real_topk, real_routing = moe_mod.top_k_lower_index, moe_mod.moe_routing

    def topk(probs, k):
        values, idx = real_topk(probs, k)
        log.append(("idx", idx))
        return values, idx

    def routing(*args, **kwargs):
        combine, aux = real_routing(*args, **kwargs)
        log.append(("aux", float(0.01 * aux["balance"].mean() + 1e-3 * aux["zloss"].mean())))
        return combine, aux

    moe_mod.top_k_lower_index, moe_mod.moe_routing = topk, routing
    try:
        yield
    finally:
        moe_mod.top_k_lower_index, moe_mod.moe_routing = real_topk, real_routing


@contextlib.contextmanager
def pinned_routing(indices, own=None):
    """Route each routing call by the next of ``indices`` (a recorded
    run's top-k expert choices, in call order) instead of its own top-k;
    the gates are this run's probabilities at those experts. Holds a run
    to another's discrete choices, so that its gradients can be compared
    where a routing flip would move an expert's slots; ``own`` (a list)
    collects the choices this run would have made."""
    from vit_ssl_tpu_torch.ops import moe as moe_mod

    real_topk, queue = moe_mod.top_k_lower_index, list(indices)

    def topk(probs, k):
        idx = queue.pop(0)
        if own is not None:
            own.append(real_topk(probs.detach(), k)[1])
        return probs.gather(-1, idx), idx

    moe_mod.top_k_lower_index = topk
    try:
        yield
    finally:
        moe_mod.top_k_lower_index = real_topk
    if queue:
        fail(f"{len(queue)} recorded routing calls were not replayed")


def routing_fidelity(torch, model, batch):
    """Each MoE block's routing decisions in one eval forward of ``batch``
    through the kernels and through the plain attention, each run pinned
    to an fp64-attention forward's choices upstream: the share of its own
    top-k assignments equal to fp64's, by block."""
    from vit_ssl_tpu_torch.data.device_augment import to_unit_float

    x = to_unit_float(batch["image"])
    exact_log = []
    with torch.no_grad():
        with exact_attention(torch), recorded_routing(exact_log):
            model(x, True)
        exact = [v for kind, v in exact_log if kind == "idx"]
        del exact_log
        shares = {}
        for label, ctx in (("kernel", contextlib.nullcontext), ("plain", plain_attention)):
            own = []
            with ctx(), pinned_routing(exact, own):
                model(x, True)
            shares[label] = [float((a == e).float().mean()) for a, e in zip(own, exact)]
    return shares


def phase_moe(torch, fa, card, tmp):
    """V-MoE ViT-B/16 (MOE_OVERRIDES on configs/vit_b_imagenet.yaml) through
    ``SupervisedTrainer.fit(1)`` over MOE_IMAGES in-memory images (2 train
    steps, 1 val step), B1's launches exact in every step; then one step
    from one cloned state against the plain-attention step: with its own
    routing, the router loss within 1e-2 of its size (the routing's drift
    printed); with its routing pinned to the kernel step's choices, the
    training bars of ``judge``; the kernel path's routing decisions as
    close to an fp64-attention forward's as the plain path's
    (``routing_fidelity``, within ROUTING_FIDELITY_SLACK);
    the warm step, img/s, device busy, peak memory and
    ``moe_dropped_frac``. Returns the fit's launches."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.config import compose, validate_train_config
    from vit_ssl_tpu_torch.data.builder import make_loaders
    from vit_ssl_tpu_torch.models.builder import build_model
    from vit_ssl_tpu_torch.ops.moe import expert_capacity
    from vit_ssl_tpu_torch.train.__main__ import get_trainer

    configs = Path(__file__).resolve().parent / "configs"
    run_dir = str(Path(tmp) / "moe")
    config = compose(configs, "vit_b_imagenet", MOE_OVERRIDES + [f"hydra.run.dir={run_dir}"])
    validate_train_config(config)
    model_cfg = config["model"]
    capacity = expert_capacity(197, 8, int(model_cfg["moe_top_k"]),
                               float(model_cfg["moe_capacity_factor"]))
    print(f"== V-MoE ViT-B/16: configs/vit_b_imagenet.yaml with {' '.join(MOE_OVERRIDES)} "
          f"(top-{model_cfg['moe_top_k']}, every {model_cfg['moe_every']}nd block, capacity "
          f"factor {model_cfg['moe_capacity_factor']}: {capacity} slots an expert an "
          f"image), remat, batch {config['training']['batch_size']}, 224 px; "
          f"SupervisedTrainer.fit(1) over {MOE_IMAGES} in-memory images; {card}",
          flush=True)
    rng = np.random.default_rng(17)
    dataset = InMemoryLabeled(
        rng.integers(0, 256, (MOE_IMAGES, 224, 224, 3), dtype=np.uint8),
        rng.integers(0, int(model_cfg["num_classes"]), MOE_IMAGES))
    train_loader, val_loader = make_loaders(config, dataset)
    trainer = get_trainer("supervised", build_model(config, "cuda"), run_dir, config,
                          train_loader, val_loader, "cuda")
    blocks = int(model_cfg["num_blocks"])
    moe_blocks = [i for i, b in enumerate(trainer.network.encoder_blocks) if b.is_moe]
    if moe_blocks != list(range(1, blocks, 2)) or not trainer.network.remat:
        fail(f"the composed config built MoE blocks {moe_blocks}, remat "
             f"{trainer.network.remat}")
    n_params = sum(p.numel() for p in trainer.network.parameters())
    print(f"  MoE blocks {moe_blocks}; {n_params / 1e6:.1f} M parameters; loaders: "
          f"{len(train_loader)} train and {len(val_loader)} val steps", flush=True)
    step_fn = trainer.train_step
    train_log, val_log = [], []
    trainer.train_step = counted_steps(trainer.train_step, train_log)
    trainer.eval_step = counted_steps(trainer.eval_step, val_log)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with no_plain_attention(fa):
        kernels.launches.clear()  # the V-MoE trainer's path starts here
        trainer.fit(1)
        launches = dict(kernels.launches)  # ... and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_train, per_val = remat_launches(fa, blocks), {fa.KERNEL: blocks}
    check_step_launches({"train": train_log, "val": val_log},
                        {"train": per_train, "val": per_val},
                        {"train": len(train_loader), "val": len(val_loader)})
    finite_history(trainer, 1)
    dropped = [float(out["moe_dropped_frac"]) for _, _, out in train_log]
    print(f"  launches over fit(1): {launches} (per train step {per_train}, per val step "
          f"{per_val}); no plain attention ran; moe_dropped_frac by step "
          f"{' '.join(f'{x:.6f}' for x in dropped)}", flush=True)

    batch = trainer._put(next(iter(train_loader)))
    host_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = step_fn(trainer.state, batch)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    warm_ms = float(np.median(host_ms))
    b = int(config["training"]["batch_size"])
    idle, busy_ms = profile_window(torch, lambda: step_fn(trainer.state, batch),
                                   f"1 V-MoE ViT-B/16 training step at batch {b} (remat)",
                                   rows=16)
    print(f"  V-MoE ViT-B/16 on {card}: warm step {warm_ms:.3f} ms median of 3 "
          f"({' / '.join(f'{x:.3f}' for x in host_ms)}; {b / warm_ms * 1e3:.1f} img/s), "
          f"host clock with torch.cuda.synchronize(), device augmentation included; "
          f"device busy {busy_ms:.2f} ms a step ({busy_ms / VIT_B_DENSE_BUSY_MS:.3f}x the "
          f"dense step's {VIT_B_DENSE_BUSY_MS} ms), idle share {idle:.3f}; peak memory over "
          f"fit(1) {peak_gb:.2f} GB (torch.cuda.max_memory_allocated); moe_dropped_frac "
          f"{float(out['moe_dropped_frac']):.6f}", flush=True)

    # one step through the kernels; the plain-attention step once with its
    # own routing (the router loss, and how far the routing drifts apart),
    # then once pinned to the kernel step's expert choices (the training
    # bars: a flipped choice moves the capacity seats of every later token
    # of its image, which the gradients of the experts' parameters follow)
    kernel_log, free_log = [], []
    kernel_state = copy.deepcopy(trainer.state)
    with recorded_routing(kernel_log):
        got = step_fn(kernel_state, batch, with_grads=True)
    del kernel_state
    counted = dict(kernels.launches)
    free_state = copy.deepcopy(trainer.state)
    with plain_attention(), recorded_routing(free_log):
        free = step_fn(free_state, batch)
    torch.cuda.synchronize()
    if dict(kernels.launches) != counted:
        fail("the plain-attention step launched a kernel")
    del free_state
    aux = [sum(v for kind, v in log if kind == "aux") for log in (kernel_log, free_log)]
    idx = [[v for kind, v in log if kind == "idx"] for log in (kernel_log, free_log)]
    del free_log
    drift = [float((a == c).float().mean()) for a, c in zip(*idx)]
    print(f"  router loss summed over {len(idx[0])} routing calls (6 MoE blocks, each "
          f"forward and its recompute): {aux[0]:.6f} against plain attention's "
          f"{aux[1]:.6f} (|d| {abs(aux[0] - aux[1]):.3e} <= {1e-2 * abs(aux[1]):.3e}); "
          f"moe_dropped_frac {float(got['moe_dropped_frac']):.6f} against "
          f"{float(free['moe_dropped_frac']):.6f}; free-running routing assignments equal "
          f"by MoE block (forward) {' '.join(f'{x:.4f}' for x in drift[:len(moe_blocks)])}: "
          f"a flipped choice moves the capacity seats of its image's later tokens, and "
          f"the flips compound block to block", flush=True)
    if (len(idx[0]) != len(idx[1]) or len(idx[0]) != 2 * len(moe_blocks)
            or abs(aux[0] - aux[1]) > 1e-2 * abs(aux[1])):
        fail("the V-MoE step's router loss disagrees with the plain-attention step")
    fidelity = routing_fidelity(torch, trainer.state.model, batch)
    print(f"  routing each decision from fp64 attention's upstream routing (eval forward, "
          f"batch {b}), assignments equal to fp64's by MoE block: kernel "
          f"{' '.join(f'{x:.5f}' for x in fidelity['kernel'])}, plain "
          f"{' '.join(f'{x:.5f}' for x in fidelity['plain'])}; means "
          f"{np.mean(fidelity['kernel']):.5f} against {np.mean(fidelity['plain']):.5f} "
          f"(kernel >= plain - {ROUTING_FIDELITY_SLACK:g})", flush=True)
    if np.mean(fidelity["kernel"]) < np.mean(fidelity["plain"]) - ROUTING_FIDELITY_SLACK:
        fail("the V-MoE kernel path routes less like fp64 attention than plain attention does")
    pinned = idx[0]
    del free, idx
    counted = dict(kernels.launches)
    plain_state = copy.deepcopy(trainer.state)
    with plain_attention(), pinned_routing(pinned):
        want = step_fn(plain_state, batch, with_grads=True)
    torch.cuda.synchronize()
    if dict(kernels.launches) != counted:
        fail("the pinned plain-attention step launched a kernel")
    del plain_state

    def exact_step():
        exact_state = copy.deepcopy(trainer.state)
        with exact_attention(torch), pinned_routing(pinned):
            return step_fn(exact_state, batch, with_grads=True)

    judge(torch, "plain attention, its routing pinned to the kernel step's", got, want,
          exact_step)
    del got, want, batch, trainer, kernel_log, pinned
    gc.collect()
    return {"moe_trainer": launches}


def phase_b1_patch_times(torch, fa, card):
    """B1's training entries at the patch-dropout shape PATCH_B1_CASE, bf16:
    kernel, plain, SDPA and bound (rows of the kernels line)."""
    b, n, h, d, dtype_name, bs = PATCH_B1_CASE
    print(f"== B1 at ViT-B/16's patch-dropout shape ({b},{n},{h}x{d}) {dtype_name} on "
          f"{card}", flush=True)
    dtype = getattr(torch, dtype_name)
    xq, xk, xv = qkv(b, n, h, d, dtype, seed=320)
    (do,) = qkv(b, n, h, d, dtype, seed=321)[:1]
    scale = 1.0 / d ** 0.5
    bounds = attention_train_bounds(b, n, h, d, dtype_name, bs)
    return {
        "fwd_stats": b1_forward_row(torch, fa, fa.KERNEL_TRAIN, ", ViT-B/16 patch dropout",
                                    xq, xk, xv, h, scale, bs, bounds["fwd"]),
        "bwd": b1_backward_row(torch, fa, xq, xk, xv, do, h, scale, bs, bounds["bwd"]),
    }


@contextlib.contextmanager
def recorded_b1_lengths(lengths):
    """Record the sequence length of each call of B1's wrapper on the model's
    path into ``lengths`` (the call itself unchanged)."""
    from vit_ssl_tpu_torch.ops import attention as attention_mod

    nhd = attention_mod.attention_nhd

    def recording(q, *args, **kwargs):
        lengths.append(q.shape[1])
        return nhd(q, *args, **kwargs)

    with routed_attention(recording, attention_mod.fused_attention,
                          attention_mod.blockwise_attention):
        yield


def phase_patch_dropout(torch, fa, card):
    """ViT-B/16 at 224 px, batch 1024, remat, ``model.patch_dropout=0.5``:
    one training step from one cloned state against the plain-attention
    step from the same generator (``judge``), every B1 call at N = 99 (CLS
    and 98 of 196 patches), launches exact; device busy beside the dense
    step's. Returns the step's launches."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.models.vit import patch_keep_count

    cfg = copy.deepcopy(VIT_B16_224)
    cfg["model"]["patch_dropout"] = 0.5
    n = 1 + patch_keep_count(196, 0.5)
    blocks = cfg["model"]["num_blocks"]
    print(f"== patch dropout: ViT-B/16 224 px train_step, model.patch_dropout=0.5 (N = "
          f"{n}), remat, batch {cfg['training']['batch_size']}; {card}", flush=True)
    state, train_step, _, batch = build_supervised_training(torch, cfg)
    if state.model.patch_dropout != 0.5 or not state.model.remat:
        fail("the ViT was built without patch dropout or remat")
    train_step(state, batch)  # warm-up
    kernel_state, plain_state = copy.deepcopy(state), copy.deepcopy(state)
    lengths = []
    with no_plain_attention(fa), recorded_b1_lengths(lengths):
        kernels.launches.clear()  # the patch-dropout step's path starts here
        got = train_step(kernel_state, batch, with_grads=True)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)  # ... and ends here
    want_launches = remat_launches(fa, blocks)
    if launches != want_launches or set(lengths) != {n} or len(lengths) != 2 * blocks:
        fail(f"the patch-dropout step launched {launches} (expected {want_launches}) at "
             f"lengths {sorted(set(lengths))} over {len(lengths)} calls (expected {n})")
    with plain_attention():
        want = train_step(plain_state, batch, with_grads=True)
    torch.cuda.synchronize()
    del plain_state

    def exact_step():
        exact_state = copy.deepcopy(state)
        with exact_attention(torch):
            return train_step(exact_state, batch, with_grads=True)

    judge(torch, "plain attention", got, want, exact_step)
    print(f"  launches {launches}: every B1 call at N = {n}", flush=True)
    del got, want, kernel_state
    host_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        train_step(state, batch)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    b = cfg["training"]["batch_size"]
    idle, busy_ms = profile_window(torch, lambda: train_step(state, batch),
                                   f"1 ViT-B/16 training step with patch dropout 0.5", rows=12)
    warm_ms = float(np.median(host_ms))
    print(f"  patch dropout 0.5 on {card}: warm step {warm_ms:.3f} ms median of 3 "
          f"({b / warm_ms * 1e3:.1f} img/s); device busy {busy_ms:.2f} ms a step "
          f"({busy_ms / VIT_B_DENSE_BUSY_MS:.3f}x the dense step's {VIT_B_DENSE_BUSY_MS} ms "
          f"at N = 197), idle share {idle:.3f}", flush=True)
    del state, batch
    gc.collect()
    return {"patch_dropout_step": launches}


HOST_IMAGES = 320  # 96 px PNGs: 256 train (two batches of 128) and 64 val at val_split 0.2
HOST_OVERRIDES = ["data.device_augment=false", "training.num_epochs=1", "eval.interval=0"]


def png_chunk(kind: bytes, body: bytes) -> bytes:
    return (len(body).to_bytes(4, "big") + kind + body
            + zlib.crc32(kind + body).to_bytes(4, "big"))


def encode_png(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of ``rgb`` (H, W, 3) uint8, row y filtered with
    PNG filter y mod 5 (None, Sub, Up, Average, Paeth in turn)."""
    h, w, _ = rgb.shape
    rows = rgb.reshape(h, w * 3).astype(np.int16)
    raw = bytearray()
    prev = np.zeros(w * 3, np.int16)
    for y in range(h):
        row, kind = rows[y], y % 5
        left = np.concatenate([np.zeros(3, np.int16), row[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int16), prev[:-3]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            pa, pb = np.abs(prev - upleft), np.abs(left - upleft)
            pc = np.abs(left + prev - 2 * upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        raw.append(kind)
        raw += ((row - pred) & 255).astype(np.uint8).tobytes()
        prev = row
    header = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, 2, 0, 0, 0])
    return (b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", header)
            + png_chunk(b"IDAT", zlib.compress(bytes(raw), 6)) + png_chunk(b"IEND", b""))


# the baseline JPEG encoder's tables (ITU-T T.81 Annex K): quantization in
# natural order, and the bits/values of the four Huffman tables
JPEG_QUANT = (np.array([  # luminance
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]),
    np.array([  # chrominance
        17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32))
JPEG_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_AC_LUMA_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a16"
    "1718191a25262728292a3435363738393a434445464748494a535455565758595a636465666768696a"
    "737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8"
    "b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434"
    "e125f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768"
    "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4"
    "b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
JPEG_HUFFMAN = {  # (class, id): (code counts by length 1-16, symbols)
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), _AC_LUMA_VALS),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), _AC_CHROMA_VALS),
}
_DCT = np.array([[(0.5 / 2 ** 0.5 if u == 0 else 0.5) * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])


def _huffman_codes(counts, symbols):
    """Code and length of each symbol (T.81 Annex C), as 256-entry arrays."""
    code_of, size_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(counts, 1):
        for _ in range(count):
            code_of[symbols[k]], size_of[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, size_of


def _quantized_blocks(plane, table):
    """(H, W) samples (H, W multiples of 8) -> (H/8, W/8, 64) quantized DCT
    coefficients in zigzag order."""
    h, w = plane.shape
    blocks = (plane - 128.0).reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    coefs = np.einsum("ux,abxy,vy->abuv", _DCT, blocks, _DCT)
    q = np.rint(coefs / table.reshape(8, 8)).astype(np.int64)
    return q.reshape(h // 8, w // 8, 64)[..., JPEG_ZIGZAG]


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def encode_jpeg(rgb: np.ndarray, quality: int = 90, subsampling: str = "420") -> bytes:
    """A baseline JFIF JPEG of ``rgb`` (H, W, 3) uint8: YCbCr at 4:2:0 or
    4:4:4, the Annex K tables scaled to ``quality`` as libjpeg scales them,
    a float DCT over all blocks at once, and the Huffman coding of every
    block vectorised (events sorted by block and coefficient, then packed
    to bits)."""
    h, w, _ = rgb.shape
    f = 2 if subsampling == "420" else 1
    mcu = 8 * f
    padded = np.pad(rgb.astype(np.float64), ((0, -h % mcu), (0, -w % mcu), (0, 0)),
                    mode="edge")
    r, g, b = padded[..., 0], padded[..., 1], padded[..., 2]
    ycc = [0.299 * r + 0.587 * g + 0.114 * b,
           -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
           0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    if f == 2:
        ycc[1:] = [c.reshape(c.shape[0] // 2, 2, c.shape[1] // 2, 2).mean((1, 3))
                   for c in ycc[1:]]
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    tables = [np.clip((t * scale + 50) // 100, 1, 255) for t in JPEG_QUANT]
    luma = _quantized_blocks(np.clip(np.rint(ycc[0]), 0, 255), tables[0])
    chroma = [_quantized_blocks(np.clip(np.rint(c), 0, 255), tables[1]) for c in ycc[1:]]
    my, mx = chroma[0].shape[:2]
    # the MCUs in order: f*f luma blocks (raster within the MCU), Cb, Cr
    luma = luma.reshape(my, f, mx, f, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, f * f, 64)
    units = np.concatenate([luma] + [c.reshape(my * mx, 1, 64) for c in chroma], axis=1)
    comp = np.array([0] * (f * f) + [1, 2])
    blocks = units.reshape(-1, 64)
    comp = np.tile(comp, my * mx)
    table = np.minimum(comp, 1)
    diff = np.empty(len(blocks), np.int64)
    for c in range(3):
        dc = blocks[comp == c, 0]
        diff[comp == c] = dc - np.concatenate([[0], dc[:-1]])
    codes = {key: _huffman_codes(*spec) for key, spec in JPEG_HUFFMAN.items()}

    def size(v):
        return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)

    def bits(v, s):
        return np.where(v >= 0, v, v + (1 << s) - 1)

    def coded(cls, tab, symbol, extra_bits, extra_size):
        code = np.where(tab == 0, codes[(cls, 0)][0][symbol], codes[(cls, 1)][0][symbol])
        length = np.where(tab == 0, codes[(cls, 0)][1][symbol], codes[(cls, 1)][1][symbol])
        return (code << extra_size) | extra_bits, length + extra_size

    ids = np.arange(len(blocks))
    s = size(diff)
    events = [(ids * 260, *coded(0, table, s, bits(diff, s), s))]
    bi, ki = np.nonzero(blocks[:, 1:])
    k = ki + 1
    v = blocks[bi, k]
    prev = np.where(np.concatenate([[False], bi[1:] == bi[:-1]]),
                    np.concatenate([[0], k[:-1]]), 0)
    run = k - prev - 1
    s = size(v)
    events.append((bi * 260 + 4 * k + 3, *coded(1, table[bi], (run % 16) * 16 + s,
                                                bits(v, s), s)))
    for j in range(3):  # runs of 16 zeros before a coefficient (ZRL, 0xF0)
        has = run // 16 > j
        zb = bi[has]
        events.append((zb * 260 + 4 * k[has] + j,
                       *coded(1, table[zb], np.full(len(zb), 0xF0), 0, 0)))
    last = np.zeros(len(blocks), np.int64)
    last[bi] = k  # k ascends within a block: the last write is the last nonzero
    eob = ids[last < 63]
    events.append((eob * 260 + 256, *coded(1, table[eob], np.zeros(len(eob), np.int64), 0, 0)))
    keys = np.concatenate([e[0] for e in events])
    order = np.argsort(keys, kind="stable")
    values = np.concatenate([e[1] for e in events])[order]
    lengths = np.concatenate([e[2] for e in events])[order]
    total = int(lengths.sum())
    starts = np.cumsum(lengths) - lengths
    within = np.arange(total) - np.repeat(starts, lengths)
    stream = (np.repeat(values, lengths) >> (np.repeat(lengths, lengths) - 1 - within)) & 1
    stream = np.concatenate([stream, np.ones(-total % 8, np.int64)]).astype(np.uint8)
    data = np.packbits(stream)
    data = np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0).tobytes()  # byte stuffing
    sampling = 0x22 if f == 2 else 0x11
    header = (b"\xff\xd8" + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
              + _segment(0xDB, b"".join(bytes([i]) + bytes(t[JPEG_ZIGZAG].astype(np.uint8))
                                        for i, t in enumerate(tables)))
              + _segment(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
                         + bytes([3, 1, sampling, 0, 2, 0x11, 1, 3, 0x11, 1]))
              + _segment(0xC4, b"".join(bytes([cls << 4 | i]) + bytes(counts) + symbols
                                        for (cls, i), (counts, symbols) in JPEG_HUFFMAN.items()))
              + _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    return header + data + b"\xff\xd9"


def phase_host_multicrop(torch, fa, card, tmp, trainer_stats):
    """DINO ViT-S/8 from a PNG folder with the views made on the host: a
    folder of HOST_IMAGES seeded 96 px PNGs (this script's encoder, every
    row filter); the port's decoder bit-equal to the encoded arrays and
    ``native_batch`` to the per-sample path; configs/dino.yaml with
    HOST_OVERRIDES and the folder through the CLI's ``main`` (the host
    multi-crop through the config's globals and locals pipelines,
    ``data.num_workers`` as composed): 2 train and 1 val steps, B1's
    launches exact, a checkpoint written; one step on a host-views batch
    against the plain-attention step from one cloned state (the DINO bars);
    the folder served through ``Server.infer`` against ``forward_batch`` on
    the decoded arrays (row cosine >= 0.999); host ms per view of each
    pipeline, decode ms per image (per sample and native), the epoch's img/s
    and input-wait share beside the device-augment trainer's. Returns the
    CLI run's launches."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.config import compose, to_container
    from vit_ssl_tpu_torch.data import png
    from vit_ssl_tpu_torch.data.builder import prepare_dataloaders
    from vit_ssl_tpu_torch.data.datasets import STL10UnsupervisedDataset
    from vit_ssl_tpu_torch.data.transforms import Compose, Resize, get_transforms
    from vit_ssl_tpu_torch.serve import Server
    from vit_ssl_tpu_torch.train import __main__ as cli

    folder = Path(tmp) / "png"
    folder.mkdir()
    images = np.random.default_rng(31).integers(0, 256, (HOST_IMAGES, 96, 96, 3),
                                                dtype=np.uint8)
    for i, image in enumerate(images):
        (folder / f"{i:05d}.png").write_bytes(encode_png(image))
    files = sorted(str(p) for p in folder.glob("*.png"))
    run_dir = str(Path(tmp) / "host_run")
    overrides = HOST_OVERRIDES + [f"data.data_dir={folder}", f"hydra.run.dir={run_dir}"]
    print(f"== host multi-crop: configs/dino.yaml with {' '.join(overrides[:-2])}, a folder "
          f"of {HOST_IMAGES} 96 px PNGs (filters 0-4 by row); the CLI's main; {card}",
          flush=True)

    t0 = time.perf_counter()
    decoded = [png.decode(f) for f in files]
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(files)
    bad = [i for i, (a, b) in enumerate(zip(decoded, images)) if not np.array_equal(a, b)]
    if bad:
        fail(f"the PNG decoder differs from the encoded arrays at files {bad[:5]}")
    dataset = STL10UnsupervisedDataset(str(folder), Compose([Resize([96, 96])]),
                                       native_decode=True)
    t0 = time.perf_counter()
    native = [x for lo in range(0, HOST_IMAGES, 128)
              for x in dataset.native_batch(range(lo, min(lo + 128, HOST_IMAGES)))]
    native_ms = (time.perf_counter() - t0) * 1e3 / HOST_IMAGES
    if len(native) != HOST_IMAGES or any(not np.array_equal(a, dataset[i])
                                         for i, a in enumerate(native)):
        fail("native_batch differs from the per-sample path")
    print(f"  decode: bit-equal to the encoded arrays; native_batch bit-equal to the "
          f"per-sample path; {decode_ms:.3f} ms an image per sample, {native_ms:.3f} ms "
          f"an image native ({os.cpu_count()} host cores)", flush=True)

    config = compose(Path(__file__).resolve().parent / "configs", "dino", overrides)
    composed = to_container(config)
    diffs = config_differences({k: DINO_VIT_S8[k] for k in ("model", "transforms")},
                               composed)
    want_training = dict(DINO_VIT_S8["training"], num_epochs=1)
    diffs += config_differences(want_training, composed["training"], "config.training")
    if diffs or composed["data"]["device_augment"]:
        fail("the composed config differs from DINO_VIT_S8: " + "; ".join(diffs))
    pipes = get_transforms(config)
    host_ms = {}
    for key in ("globals", "locals"):
        t0 = time.perf_counter()
        for i, image in enumerate(decoded[:64]):
            pipes[key](image, np.random.default_rng(i))
        host_ms[key] = (time.perf_counter() - t0) * 1e3 / 64
    views = DINO_VIT_S8["training"]["num_global_views"]
    per_image = views * host_ms["globals"] + (
        DINO_VIT_S8["training"]["num_all_views"] - views) * host_ms["locals"]
    print(f"  composed config: model, training (num_epochs 1) and transforms equal "
          f"DINO_VIT_S8; host pipelines on one thread: globals {host_ms['globals']:.3f} "
          f"ms a view, locals {host_ms['locals']:.3f} ms a view, {per_image:.3f} ms an "
          f"image's 6 views; data.num_workers {config.data.num_workers}", flush=True)

    trainers, train_log, val_log = [], [], []
    get_trainer = cli.get_trainer

    def recorded(*args, **kwargs):
        trainer = get_trainer(*args, **kwargs)
        trainer.train_step = counted_steps(trainer.train_step, train_log)
        trainer.eval_step = counted_steps(trainer.eval_step, val_log)
        trainers.append(trainer)
        return trainer

    cli.get_trainer = recorded
    try:
        with no_plain_attention(fa):
            kernels.launches.clear()  # the host multi-crop path starts here
            t0 = time.perf_counter()
            cli.main(["--config-path", str(Path(__file__).resolve().parent / "configs"),
                      "--config-name", "dino", *overrides])
            run_s = time.perf_counter() - t0
            launches = dict(kernels.launches)  # ... and ends here
    finally:
        cli.get_trainer = get_trainer
    blocks = DINO_VIT_S8["model"]["num_blocks"]
    per_train, per_val = attention_launches(fa), {fa.KERNEL: 3 * blocks}
    if (len(train_log), len(val_log)) != (2, 1):
        fail(f"the CLI ran {len(train_log)} train and {len(val_log)} val steps, "
             "expected 2 and 1")
    for kind, log, want in (("train", train_log, per_train), ("val", val_log, per_val)):
        for i, (_, got, _) in enumerate(log):
            if got != want:
                fail(f"{kind} step {i} of the host multi-crop run launched {got}, "
                     f"expected {want}")
    if any(launches.get(name, 0) == 0 for name in (fa.KERNEL, fa.KERNEL_TRAIN,
                                                     fa.KERNEL_BWD)):
        fail(f"the host multi-crop run left a B1 entry unlaunched: {launches}")
    for name in ("best_model", "last_model"):
        if not (Path(run_dir) / name / "state.pt").exists():
            fail(f"the host multi-crop run wrote no {name}")
    trainer = trainers[0]
    losses = [float(out["loss"]) for _, _, out in train_log + val_log]
    if not np.isfinite(losses).all():
        fail(f"a host multi-crop loss is not finite: {losses}")
    stats = trainer.epoch_input_stats[0]
    real = len(trainer.train_loader.dataset)
    rate, wait = real / stats["wall_s"], stats["wait_s"] / stats["wall_s"]
    print(f"  launches: {launches} (per train step {per_train}, per val step {per_val}); "
          f"losses {' '.join(f'{x:.6f}' for x in losses)}; the CLI call {run_s:.3f} s",
          flush=True)
    print(f"  epoch on {card}: {real} images in {stats['wall_s']:.3f} s wall "
          f"({rate:.1f} img/s), input-wait share {wait:.4f}; the device-augment "
          f"trainer's epochs: " + ", ".join(
              f"{r:.1f} img/s at input-wait {w:.4f}" for r, w in zip(
                  trainer_stats["images_per_s"], trainer_stats["input_wait_share"])),
          flush=True)
    del trainer, trainers
    gc.collect()

    batches = iter(prepare_dataloaders(config, "dino")[0])
    batch = next(batches)
    batches.close()  # stops the loader's producer thread
    batch = {"views": [torch.from_numpy(v).cuda() for v in batch["views"]],
             "weight": torch.from_numpy(batch["weight"]).cuda()}
    print("  one step on this host-views batch, B1 against plain attention:", flush=True)
    state, train_step, _ = build_training(torch)
    agreement(torch, fa, state, train_step, batch)
    del state, train_step, batch
    gc.collect()

    pth = f"{tmp}/host_dino.pth"
    write_checkpoint(torch, DINO_VIT_S8, pth)
    server = Server(pth, batch_size=SERVE_BATCH, device="cuda")
    records = server.infer(files[:SERVE_BATCH])
    errors = [r for r in records if "error" in r]
    if errors:
        fail(f"serving the PNG folder gave error records: {errors[:2]}")
    got = np.asarray([r["embedding"] for r in records], np.float32)
    want = server.forward_batch(np.stack(decoded[:SERVE_BATCH]).astype(np.float32) / 255)
    cos = row_cosine(got, want)
    print(f"  served {len(records)} PNGs through Server.infer: min row cosine "
          f"{cos.min():.6f} to forward_batch on the decoded arrays (>= 0.999)",
          flush=True)
    if cos.min() < 0.999:
        fail("the served PNGs disagree with forward_batch on the decoded arrays")
    del server
    gc.collect()
    return launches


# ViT-B/16 from an ImageNet-layout JPEG folder: JPEG_IMAGES seeded images at
# ImageNet's common sizes ((h, w)), encoded by encode_jpeg, hard-linked under
# JPEG_FILES distinct names into JPEG_CLASSES class folders; at the config's
# val_split 0.04 that is 512 train images (2 steps at batch 256) and 21 val
# images (1 step)
JPEG_IMAGES = 64
JPEG_FILES = 533
JPEG_CLASSES = 10
JPEG_SIZES = [(375, 500), (500, 375), (500, 333), (334, 500), (256, 256)]
JPEG_OVERRIDES = ["training.batch_size=256", "training.num_epochs=1"]
JPEG_SERVE = 64
JPEG_THREADS = 8


def smooth_picture(rng, h, w):
    """A seeded (h, w, 3) uint8 picture: a coarse random grid bilinearly
    upsampled, with noise on it."""
    coarse = rng.integers(0, 256, (h // 25 + 2, w // 25 + 2, 3)).astype(np.float64)
    ys = np.linspace(0, coarse.shape[0] - 1.001, h)
    xs = np.linspace(0, coarse.shape[1] - 1.001, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    top = coarse[y0][:, x0] * (1 - fx) + coarse[y0][:, x0 + 1] * fx
    bottom = coarse[y0 + 1][:, x0] * (1 - fx) + coarse[y0 + 1][:, x0 + 1] * fx
    image = top * (1 - fy) + bottom * fy + rng.normal(0, 6, (h, w, 3))
    return np.clip(np.rint(image), 0, 255).astype(np.uint8)


def step_under_load(torch, step, load):
    """Median ms of 3 ``step()`` calls (each ending in a synchronise) while
    JPEG_THREADS threads call ``load(i)`` over the pictures in a loop."""
    import threading

    stop = threading.Event()

    def work(first):
        i = first
        while not stop.is_set():
            load(i % JPEG_IMAGES)
            i += JPEG_THREADS

    threads = [threading.Thread(target=work, args=(k,)) for k in range(JPEG_THREADS)]
    for thread in threads:
        thread.start()
    try:
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        stop.set()
        for thread in threads:
            thread.join()
    return float(np.median(times))


def phase_jpeg_folder(torch, fa, card, tmp):
    """ViT-B/16 from an ImageNet-layout JPEG folder, with the port's own
    decoder: (a) the host library built with the host compiler; (b) every
    committed fixture of ``tests/torch_jpeg_fixtures`` decoded bit-equal to
    the digests recorded from cv2 and PIL; (c) a folder of JPEG_FILES
    hard links to JPEG_IMAGES seeded pictures (this script's encoder, 4:2:0
    and 4:4:4) in JPEG_CLASSES classes; (d) configs/vit_b_imagenet.yaml with
    the folder and JPEG_OVERRIDES through the CLI's ``main`` (the model as
    written, ``data.num_workers`` as composed): 2 train and 1 val steps, B1's
    launches exact, a checkpoint written; (e) one step on a JPEG batch
    against the plain-attention step from one cloned state (the ViT-B/16
    bars); (f) the folder's first JPEG_SERVE files through ``Server.infer``
    against ``forward_batch`` on the decoded arrays (row cosine >= 0.999);
    (g) decode ms an image on one thread and across JPEG_THREADS threads,
    the epoch's img/s, input-wait share and step-to-step seconds, a sample's
    decode and resize on one thread, and the bare step alone and while
    JPEG_THREADS threads decode, or decode and resize. Returns the paths'
    launches."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.config import compose, to_container
    from vit_ssl_tpu_torch.data import jpeg
    from vit_ssl_tpu_torch.data.transforms import Compose, Resize, ToTensor
    from vit_ssl_tpu_torch.serve import Server
    from vit_ssl_tpu_torch.train import __main__ as cli

    root = Path(__file__).resolve().parent
    print(f"== JPEG folder: ViT-B/16 224 px from {JPEG_FILES} ImageNet-layout JPEGs "
          f"({JPEG_IMAGES} distinct) through the port's decoder; configs/vit_b_imagenet.yaml "
          f"with the folder and {' '.join(JPEG_OVERRIDES)}; the CLI's main; {card}",
          flush=True)
    build_s = kernels.build_host(jpeg.LIBRARY)
    print(f"  host library: {kernels.library_path(jpeg.LIBRARY).name} from "
          f"{kernels.HOST_SOURCES[jpeg.LIBRARY]} with {kernels.host_compiler()} "
          f"{' '.join(kernels.HOST_FLAGS)}: {build_s:.3f} s (0: already built)", flush=True)

    fixtures = root / "tests" / "torch_jpeg_fixtures"
    digests = json.loads((fixtures / "digests.json").read_text())
    server_options = {"exif_orientation": False, "cmyk": "pil"}
    for name, want in sorted(digests.items()):
        data = (fixtures / name).read_bytes()
        for key, options in (("cv2", {}), ("pil", server_options)):
            got = jpeg.decode_bytes(data, **options)
            digest = {"shape": list(got.shape),
                      "sha256": hashlib.sha256(got.tobytes()).hexdigest()}
            if digest != want[key]:
                fail(f"the JPEG fixture {name} ({want['case']}) decodes to {digest}, "
                     f"not {key}'s {want[key]}")
    print(f"  fixtures: {len(digests)} files ({'; '.join(v['case'] for v in digests.values())}) "
          "each bit-equal to its cv2 and PIL digests", flush=True)

    rng = np.random.default_rng(41)
    sources, encoded = Path(tmp) / "jpeg_sources", []
    sources.mkdir()
    t0 = time.perf_counter()
    pictures = []
    for i in range(JPEG_IMAGES):
        h, w = JPEG_SIZES[i % len(JPEG_SIZES)]
        pictures.append(smooth_picture(rng, h, w))
        quality, sampling = (90, 75)[i % 2], ("420", "444")[(i // 2) % 2]
        encoded.append(encode_jpeg(pictures[-1], quality, sampling))
        (sources / f"{i:03d}.jpg").write_bytes(encoded[-1])
    encode_s = time.perf_counter() - t0
    folder = Path(tmp) / "imagenet" / "train"
    for j in range(JPEG_FILES):
        cls = folder / f"n{j % JPEG_CLASSES:08d}"
        cls.mkdir(parents=True, exist_ok=True)
        os.link(sources / f"{j % JPEG_IMAGES:03d}.jpg", cls / f"n{j % JPEG_CLASSES:08d}_{j}.JPEG")
    decoded = [jpeg.decode_bytes(d) for d in encoded]
    psnr = [10 * np.log10(255 ** 2 / np.mean((a.astype(np.float64) - b) ** 2))
            for a, b in zip(decoded, pictures)]
    if any(a.shape != b.shape for a, b in zip(decoded, pictures)) or min(psnr) < 30:
        fail(f"the decoded folder images are off their pictures: PSNR {min(psnr):.2f} dB")
    print(f"  folder: {JPEG_IMAGES} pictures at {JPEG_SIZES} (h, w) encoded in "
          f"{encode_s:.3f} s ({sum(map(len, encoded)) / 1e6:.3f} MB, quality 90/75, 4:2:0 "
          f"and 4:4:4), {JPEG_FILES} hard links in {JPEG_CLASSES} classes; decoded PSNR "
          f"{min(psnr):.2f}-{max(psnr):.2f} dB to the pictures", flush=True)

    for data in encoded[:4]:  # warm
        jpeg.decode_bytes(data)
    t0 = time.perf_counter()
    for data in encoded:
        jpeg.decode_bytes(data)
    one_ms = (time.perf_counter() - t0) * 1e3 / len(encoded)
    work = encoded * 4
    with ThreadPoolExecutor(JPEG_THREADS) as pool:
        list(pool.map(jpeg.decode_bytes, encoded[:JPEG_THREADS]))
        t0 = time.perf_counter()
        list(pool.map(jpeg.decode_bytes, work))
        many_ms = (time.perf_counter() - t0) * 1e3 / len(work)
    host = {"decode_ms_one_thread": one_ms, "decode_ms_per_image_threads": many_ms,
            "threads": JPEG_THREADS, "scaling": one_ms / many_ms,
            "host_cores": os.cpu_count()}
    print(f"  decode on {card}'s host ({os.cpu_count()} cores): {one_ms:.3f} ms an image on "
          f"one thread; {len(work)} decodes across {JPEG_THREADS} threads {many_ms:.3f} ms "
          f"an image ({one_ms / many_ms:.2f}x)", flush=True)

    run_dir = str(Path(tmp) / "jpeg_run")
    overrides = [f"data.data_dir={folder}", *JPEG_OVERRIDES, f"hydra.run.dir={run_dir}"]
    config = compose(root / "configs", "vit_b_imagenet", overrides)
    composed = to_container(config)
    diffs = config_differences({k: VIT_B16_224[k] for k in ("model", "parallel")}, composed)
    if diffs or composed["data"]["num_workers"] != 8 or composed["data"]["img_size"] != 224:
        fail("the composed config differs from VIT_B16_224: " + "; ".join(diffs))
    print(f"  overrides: {' '.join(overrides)}; model (ViT-B/16, 1000-class head) and "
          f"parallel (remat on) equal VIT_B16_224; data.num_workers "
          f"{composed['data']['num_workers']}", flush=True)

    trainers, raw_steps, train_log, val_log = [], [], [], []
    get_trainer = cli.get_trainer

    def recorded(*args, **kwargs):
        trainer = get_trainer(*args, **kwargs)
        raw_steps.append(trainer.train_step)
        trainer.train_step = counted_steps(trainer.train_step, train_log)
        trainer.eval_step = counted_steps(trainer.eval_step, val_log)
        trainers.append(trainer)
        return trainer

    cli.get_trainer = recorded
    try:
        with no_plain_attention(fa):
            kernels.launches.clear()  # the JPEG-folder path starts here
            t0 = time.perf_counter()
            cli.main(["--config-path", str(root / "configs"), "--config-name",
                      "vit_b_imagenet", *overrides])
            run_s = time.perf_counter() - t0
            launches = dict(kernels.launches)  # ... and ends here
    finally:
        cli.get_trainer = get_trainer
    blocks = VIT_B16_224["model"]["num_blocks"]
    per_train, per_val = remat_launches(fa, blocks), {fa.KERNEL: blocks}
    if (len(train_log), len(val_log)) != (2, 1):
        fail(f"the CLI ran {len(train_log)} train and {len(val_log)} val steps, "
             "expected 2 and 1")
    for kind, log, want in (("train", train_log, per_train), ("val", val_log, per_val)):
        for i, (_, got, _) in enumerate(log):
            if got != want:
                fail(f"{kind} step {i} of the JPEG-folder run launched {got}, "
                     f"expected {want}")
    for name in ("best_model", "last_model"):
        if not (Path(run_dir) / name / "state.pt").exists():
            fail(f"the JPEG-folder run wrote no {name}")
    trainer = trainers[0]
    losses = [float(out["loss"]) for _, _, out in train_log + val_log]
    if not np.isfinite(losses).all():
        fail(f"a JPEG-folder loss is not finite: {losses}")
    stats = trainer.epoch_input_stats[0]
    real = len(trainer.train_loader.dataset)
    starts = [t for t, _, _ in train_log + val_log]
    host.update(images_per_s=real / stats["wall_s"], input_wait_share=stats["wait_s"]
                / stats["wall_s"], epoch_wall_s=stats["wall_s"], cli_s=run_s,
                in_loop_step_s=[b - a for a, b in zip(starts, starts[1:])])
    samples = trainer.train_loader.dataset
    t0 = time.perf_counter()
    for i in range(JPEG_IMAGES):
        samples[i]
    host["sample_ms_one_thread"] = (time.perf_counter() - t0) * 1e3 / JPEG_IMAGES
    print(f"  launches: {launches} (per train step {per_train}, per val step {per_val}); "
          f"losses {' '.join(f'{x:.6f}' for x in losses)}; best_model and last_model "
          f"written; the CLI call {run_s:.3f} s", flush=True)
    print(f"  epoch on {card}: {real} images in {stats['wall_s']:.3f} s wall "
          f"({host['images_per_s']:.1f} img/s), input-wait share "
          f"{host['input_wait_share']:.4f}; from one step's start to the next "
          f"{' / '.join(f'{t:.3f}' for t in host['in_loop_step_s'])} s; one thread "
          f"decodes and resizes a sample in {host['sample_ms_one_thread']:.3f} ms",
          flush=True)

    batches = iter(trainer.train_loader)
    batch = trainer._put(next(batches))
    batches.close()  # stops the loader's producer thread
    step_fn = raw_steps[0]
    print("  one step on this JPEG batch, B1 against plain attention:", flush=True)
    kernel_state, plain_state = copy.deepcopy(trainer.state), copy.deepcopy(trainer.state)
    got = step_fn(kernel_state, batch, with_grads=True)
    counted = dict(kernels.launches)
    with plain_attention():
        want = step_fn(plain_state, batch, with_grads=True)
    torch.cuda.synchronize()
    if dict(kernels.launches) != counted:
        fail("the plain-attention step launched a kernel")
    del kernel_state, plain_state

    def exact_step():
        exact_state = copy.deepcopy(trainer.state)
        with exact_attention(torch):
            return step_fn(exact_state, batch, with_grads=True)

    judge(torch, "plain attention", got, want, exact_step)
    del got, want
    bare = []
    for _ in range(4):
        t0 = time.perf_counter()
        step_fn(trainer.state, batch)
        torch.cuda.synchronize()
        bare.append((time.perf_counter() - t0) * 1e3)
    host["warm_step_ms"] = float(np.median(bare[1:]))
    print(f"  the bare step on this batch, no loader running: "
          f"{' / '.join(f'{t:.3f}' for t in bare)} ms (the first after the agreement "
          f"check; median of the last 3 {host['warm_step_ms']:.3f} ms, "
          f"{256 / host['warm_step_ms'] * 1e3:.1f} img/s)", flush=True)
    for label, load in (("decode", lambda i: jpeg.decode_bytes(encoded[i])),
                        ("decode_resize", lambda i: samples[i])):
        host[f"step_ms_under_{label}"] = step_under_load(
            torch, lambda: step_fn(trainer.state, batch), load)
    print(f"  the same step while {JPEG_THREADS} threads decode: "
          f"{host['step_ms_under_decode']:.3f} ms; while they decode and resize to "
          f"224 (the loader's work): {host['step_ms_under_decode_resize']:.3f} ms "
          "(medians of 3)", flush=True)
    del batch, trainer, trainers, raw_steps
    gc.collect()

    pth = f"{tmp}/vit_b16_224.pth"
    model = build_vit_model(torch, 5, composed)
    torch.save({"model_state_dict": model.state_dict(), "config": composed, "epoch": 0}, pth)
    del model
    server = Server(pth, batch_size=JPEG_SERVE, device="cuda")
    paths = sorted(str(f) for f in folder.rglob("*.JPEG"))[:JPEG_SERVE]
    rows, format_record = [], server._format

    def captured(path, row):
        rows.append(row)
        return format_record(path, row)

    server._format = captured
    with no_plain_attention(fa):
        kernels.launches.clear()  # the JPEG serving path starts here
        records = server.infer(paths)
        serve_launches = dict(kernels.launches)  # ... and ends here
    errors = [r for r in records if "error" in r]
    if errors:
        fail(f"serving the JPEG folder gave error records: {errors[:2]}")
    if serve_launches != {fa.KERNEL: blocks}:
        fail(f"the served batch launched {serve_launches}, expected {fa.KERNEL}: {blocks}")
    pipeline = Compose([Resize([224, 224]), ToTensor()])
    arrays = np.stack([pipeline(jpeg.decode(p, **server_options)) for p in paths])
    ref = server.forward_batch(arrays)
    cos = row_cosine(np.stack(rows), ref)
    same = [r["pred"] for r in records] == [int(x) for x in ref.argmax(1)]
    print(f"  served {len(records)} JPEGs through Server.infer: min row cosine "
          f"{cos.min():.6f} to forward_batch on the decoded arrays (>= 0.999), preds "
          f"{'equal' if same else 'differ'}; launches {serve_launches}", flush=True)
    if cos.min() < 0.999 or not same:
        fail("the served JPEGs disagree with forward_batch on the decoded arrays")
    print("jpeg_decode host: " + json.dumps(host), flush=True)
    del server
    gc.collect()
    return {"jpeg_folder": launches, "jpeg_serving": serve_launches}


# The visualizer phase: the three scripts of vit_ssl_tpu_torch.scripts over
# the run directories of the DINO, SimMIM and ViT-B/16 trainer phases, each
# through its main() as a user runs it; B1 at batch 1 beside SDPA
VIS_COSINE = 0.999  # each row of a heat map or image against the plain path
VIS_UMAP_IMAGES = 640  # 96 px PNGs in 10 class folders: 512 train, 128 val
VIS_UMAP_CLASSES = 10


@contextlib.contextmanager
def recorded_b1_shapes(shapes):
    """Record (batch, seq, heads x head_dim) of each call of B1's wrapper on
    the model's path into ``shapes`` (the call itself unchanged)."""
    from vit_ssl_tpu_torch.ops import attention as attention_mod

    nhd = attention_mod.attention_nhd

    def recording(q, k, v, num_heads, *args, **kwargs):
        shapes.append((q.shape[0], q.shape[1], f"{num_heads}x{q.shape[2] // num_heads}"))
        return nhd(q, k, v, num_heads, *args, **kwargs)

    with routed_attention(recording, attention_mod.fused_attention,
                          attention_mod.blockwise_attention):
        yield


def visualizer_image(tmp, name, seed):
    """A seeded 375 x 500 picture as a baseline JPEG (this script's encoder)
    in ``tmp``; its path."""
    path = Path(tmp) / name
    path.write_bytes(encode_jpeg(smooth_picture(np.random.default_rng(seed), 375, 500)))
    return str(path)


def plain_twin(torch, ckpt):
    """The checkpoint's model on the card twice, as its config builds it and
    with ``model.use_flash_attention=false``: (kernel model, plain model,
    config)."""
    from vit_ssl_tpu_torch.config import from_container
    from vit_ssl_tpu_torch.models.builder import build_model
    from vit_ssl_tpu_torch.utils.checkpoint import load_checkpoint

    tree, meta = load_checkpoint(ckpt)
    plain_cfg = copy.deepcopy(meta["config"])
    plain_cfg["model"]["use_flash_attention"] = False
    models = []
    for cfg in (meta["config"], plain_cfg):
        model = build_model(from_container(cfg), "cuda")
        model.load_state_dict(tree["model"])
        models.append(model.eval())
    return models[0], models[1], from_container(meta["config"])


def visualizer_run(fa, fn):
    """``fn()`` as a main path: the launch counts zeroed just before and read
    just after, every B1 call's shape recorded, no plain attention version
    allowed; (its result, launches, shapes, wall seconds)."""
    import torch
    from vit_ssl_tpu_torch import kernels

    shapes = []
    torch.cuda.synchronize()
    with no_plain_attention(fa), recorded_b1_shapes(shapes):
        t0 = time.perf_counter()
        kernels.launches.clear()  # the visualizer's path starts here
        out = fn()
        torch.cuda.synchronize()
        launches = dict(kernels.launches)  # ... and ends here
        wall_s = time.perf_counter() - t0
    return out, launches, shapes, wall_s


def check_visualizer_launches(fa, name, launches, shapes, calls, shape):
    want = f"{shape[2]}x{shape[3]}"
    if launches != {fa.KERNEL: calls} or set(shapes) != {(shape[0], shape[1], want)}:
        fail(f"the {name} launched {launches} at {sorted(set(shapes))}, expected "
             f"{calls} B1 inference forwards at ({shape[0]}, {shape[1]}, {want})")


def phase_visualize_attention(torch, fa, card, run_dir, tmp):
    """``python -m vit_ssl_tpu_torch.scripts.attention_visualizer`` on the
    ViT-B/16 trainer's best_model (224 px) and a JPEG, through its ``main``:
    11 B1 inference forwards at (1, 197, 12 x 64) (the last block's
    probabilities are the plain math, as in JAX), the heat map within row
    cosine VIS_COSINE of the same forward with
    ``model.use_flash_attention=false``, the predicted class equal outside
    a near tie. Returns (launches, wall seconds)."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.scripts import attention_visualizer as av

    ckpt = str(Path(run_dir) / "best_model")
    image = visualizer_image(tmp, "attention.jpg", 41)
    output = str(Path(tmp) / "attention_overlay.png")
    print(f"== visualizers: attention map of the ViT-B/16 trainer's best_model at 224 px "
          f"(vit_ssl_tpu_torch.scripts.attention_visualizer.main); {card}", flush=True)
    (pred, heat), launches, shapes, wall_s = visualizer_run(fa, lambda: av.main(
        ["--checkpoint", ckpt, "--image", image, "--output", output]))
    blocks = VIT_B16_224["model"]["num_blocks"]
    check_visualizer_launches(fa, "attention visualizer", launches, shapes, blocks - 1,
                              VIT_B_B1_ONE)
    model, plain, config = plain_twin(torch, ckpt)
    counted = dict(kernels.launches)
    _, plain_pred, plain_heat = av.attention_arrays(plain, config, image)
    x = torch.as_tensor(av.load_image(image, 224))[None].cuda()
    with torch.inference_mode():
        want = plain(x).float().cpu().numpy()
        if dict(kernels.launches) != counted:
            fail("the plain-attention attention map launched a kernel")
        got = model(x).float().cpu().numpy()
    cos = row_cosine(heat, plain_heat)
    max_err = float(np.abs(got - want).max())
    near_tie = float(top2_margin(want)[0]) <= 2 * max_err
    print(f"  main: {wall_s:.3f} s wall (checkpoint load, JPEG decode, forward, heat map; "
          f"matplotlib {'drew ' + output if Path(output).exists() else 'absent: no figure'}); "
          f"launches {launches}, every B1 call at {shapes[0]}; heat map {heat.shape}, min row "
          f"cosine {cos.min():.6f} to model.use_flash_attention=false (>= {VIS_COSINE}); "
          f"predicted class {pred}, plain {plain_pred} (logits max_abs_err {max_err:.3e}, "
          f"top-2 margin {float(top2_margin(want)[0]):.3e}); {card}", flush=True)
    if heat.shape != (224, 224) or not np.isfinite(heat).all() or cos.min() < VIS_COSINE:
        fail("the attention map disagrees with the plain-attention forward")
    if pred != plain_pred and not near_tie:
        fail(f"the attention visualizer predicts {pred}, the plain path {plain_pred}")
    del model, plain
    gc.collect()
    return launches, wall_s


def phase_visualize_simmim(torch, fa, card, run_dir, tmp):
    """``python -m vit_ssl_tpu_torch.scripts.simmim_visualizer`` on the
    SimMIM trainer's best_model (192 px) and a JPEG, through its ``main``
    (seed 0): 6 B1 inference forwards at (1, 144, 6 x 64), the three images
    within row cosine VIS_COSINE of the plain path's with the same mask.
    Returns (launches, wall seconds)."""
    from vit_ssl_tpu_torch import kernels
    from vit_ssl_tpu_torch.scripts import simmim_visualizer as sv

    ckpt = str(Path(run_dir) / "best_model")
    image = visualizer_image(tmp, "simmim.jpg", 42)
    output = str(Path(tmp) / "simmim_reconstruction.png")
    print(f"== visualizers: SimMIM reconstruction of the SimMIM trainer's best_model at "
          f"192 px (vit_ssl_tpu_torch.scripts.simmim_visualizer.main); {card}", flush=True)
    images, launches, shapes, wall_s = visualizer_run(fa, lambda: sv.main(
        ["--checkpoint", ckpt, "--image", image, "--output", output, "--seed", "0"]))
    check_visualizer_launches(fa, "SimMIM visualizer", launches, shapes,
                              SIMMIM_VIT_S16["model"]["num_blocks"], SIMMIM_B1_ONE)
    _, plain, config = plain_twin(torch, ckpt)
    counted = dict(kernels.launches)
    want = sv.reconstruction_arrays(plain, config, image, seed=0)
    if dict(kernels.launches) != counted:
        fail("the plain-attention reconstruction launched a kernel")
    masked = float(np.isclose(images[1], 0.5).all(axis=-1).mean())
    worst = []
    for title, got, ref in zip(sv.TITLES, images, want):
        cos = row_cosine(got.reshape(got.shape[0], -1), ref.reshape(ref.shape[0], -1))
        worst.append(float(cos.min()))
        if got.shape != (192, 192, 3) or not np.isfinite(got).all() or cos.min() < VIS_COSINE:
            fail(f"the SimMIM {title} image disagrees with the plain path "
                 f"(min row cosine {cos.min():.6f})")
    print(f"  main: {wall_s:.3f} s wall (checkpoint load, JPEG decode, masked forward, "
          f"images; matplotlib "
          f"{'drew ' + output if Path(output).exists() else 'absent: no figure'}); launches "
          f"{launches}, every B1 call at {shapes[0]}; {masked:.3f} of the pixels masked "
          f"(mask ratio {config['model']['mask_ratio']}); min row cosine to "
          f"model.use_flash_attention=false with the same mask: "
          + ", ".join(f"{t} {c:.6f}" for t, c in zip(sv.TITLES, worst))
          + f" (>= {VIS_COSINE}); {card}", flush=True)
    del plain
    gc.collect()
    return launches, wall_s


def phase_visualize_umap(torch, fa, card, run_dir, tmp):
    """``python -m vit_ssl_tpu_torch.scripts.umap_3d_visualizer`` on the DINO
    trainer's run directory (eval.experiment_path) over an ImageNet-layout
    folder of VIS_UMAP_IMAGES PNGs (this script's encoder), through its
    ``main``: 6 B1 inference forwards at (128, 145, 6 x 64) in each feature
    batch, a finite (n, 3) embedding, and the GIF of 90 frames where
    matplotlib and PIL are installed, else one warning naming them.
    Returns (launches, wall seconds)."""
    import logging

    from vit_ssl_tpu_torch.config import compose
    from vit_ssl_tpu_torch.data.builder import prepare_dataloaders
    from vit_ssl_tpu_torch.evaluators import merge_with_experiment_config
    from vit_ssl_tpu_torch.scripts import umap_3d_visualizer as uv

    configs = Path(__file__).resolve().parent / "configs"
    rng = np.random.default_rng(43)
    labels = rng.integers(0, VIS_UMAP_CLASSES, VIS_UMAP_IMAGES)
    colours = rng.integers(0, 160, (VIS_UMAP_CLASSES, 3))
    folder = Path(tmp) / "umap_images"
    for i, label in enumerate(labels):
        pixels = rng.integers(0, 96, (96, 96, 3)) + colours[label]
        (folder / f"class_{label}").mkdir(parents=True, exist_ok=True)
        (folder / f"class_{label}" / f"{i:04d}.png").write_bytes(
            encode_png(pixels.astype(np.uint8)))
    overrides = [f"eval.experiment_path={run_dir}", "eval.dataset_name=imagefolder",
                 f"eval.data_dir={folder}"]
    config = merge_with_experiment_config(compose(configs, "eval_config", overrides))
    batches = sum(len(loader) for loader in prepare_dataloaders(config, "eval_knn"))
    print(f"== visualizers: 3D UMAP of the DINO trainer's run over {VIS_UMAP_IMAGES} "
          f"PNGs in {VIS_UMAP_CLASSES} class folders "
          f"(vit_ssl_tpu_torch.scripts.umap_3d_visualizer.main, {' '.join(overrides[1:2])}); "
          f"{card}", flush=True)
    warnings = []

    class Keep(logging.Handler):
        def emit(self, record):
            if record.levelno >= logging.WARNING:
                warnings.append(record.getMessage())

    handler = Keep()
    analysis = logging.getLogger("vit_ssl_tpu_torch.evaluators.embedding_analysis")
    analysis.addHandler(handler)
    try:
        embedding, launches, shapes, wall_s = visualizer_run(fa, lambda: uv.main(
            ["--config-path", str(configs), *overrides]))
    finally:
        analysis.removeHandler(handler)
    check_visualizer_launches(fa, "3D UMAP visualizer", launches, shapes,
                              DINO_VIT_S8["model"]["num_blocks"] * batches,
                              (128, 145, 6, 64))
    gif = Path(run_dir) / "umap_3d_rotation.gif"
    try:
        import matplotlib  # noqa: F401
        import PIL  # noqa: F401
        drawing = True
    except ImportError:
        drawing = False
    if drawing:
        from PIL import Image

        with Image.open(gif) as frames:
            ok, note = frames.n_frames == 90, f"{gif.name} of {frames.n_frames} frames"
    else:
        ok = (len(warnings) == 1 and str(gif) in warnings[0] and "matplotlib" in warnings[0]
              and not gif.exists())
        note = f"no GIF, warned: {warnings}"
    print(f"  main: {wall_s:.3f} s wall (features of {batches} batches, the 3D projection, "
          f"the animation); launches {launches}, every B1 call at {shapes[0]}; embedding "
          f"{embedding.shape}, finite {bool(np.isfinite(embedding).all())}; {note}; {card}",
          flush=True)
    if embedding.shape != (VIS_UMAP_IMAGES, 3) or not np.isfinite(embedding).all() or not ok:
        fail("the 3D UMAP visualizer's embedding or animation is wrong")
    return launches, wall_s


def phase_b1_batch1_times(torch, fa, card):
    """B1's inference forward at the visualizers' batch-1 shapes, bf16:
    max_abs_err to its plain version, kernel (CUDA events), plain, SDPA,
    the C entry alone, the wrapper's host microseconds, the bound (rows of
    the kernels line)."""
    rows = []
    for (b, n, h, d, dtype_name, bs), label, seed in (
            (VIT_B_B1_ONE, ", attention map", 330), (SIMMIM_B1_ONE, ", SimMIM reconstruction", 331)):
        print(f"== B1 at batch 1 ({b},{n},{h}x{d}) {dtype_name}{label} on {card}", flush=True)
        xq, xk, xv = qkv(b, n, h, d, getattr(torch, dtype_name), seed=seed)
        scale = 1.0 / d ** 0.5
        err = max_abs(fa.attention_nhd_fwd(xq, xk, xv, h, scale, bs),
                      fa.attention_nhd_reference(xq, xk, xv, h, scale, bs))
        row = b1_forward_row(torch, fa, fa.KERNEL, label, xq, xk, xv, h, scale, bs,
                             attention_bound(b, n, h, d, dtype_name, bs))
        rows.append({**row, "max_abs_err": err})
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    try:
        from vit_ssl_tpu_torch import kernels
        from vit_ssl_tpu_torch.ops import flash_attention as fa
        from vit_ssl_tpu_torch.ops import flash_blockwise as fb
        from vit_ssl_tpu_torch.ops import fused_mlp as fm
        from vit_ssl_tpu_torch.ops import masked_matmul as mm
    except ImportError as e:
        print(f"chip_smoke: the vit_ssl_tpu_torch package is missing ({e}); "
              "run from the root of a checkout", file=sys.stderr)
        return 1

    # the plain versions are the yardstick: full fp32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"== device: {card} ({torch.cuda.get_device_name(0)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda})", flush=True)

    t0 = time.perf_counter()
    built = kernels.build()
    print(f"== build: {sorted(kernels.SOURCES)} in {time.perf_counter() - t0:.1f} s "
          f"(compiled: {sorted(built)})", flush=True)
    faults, b4_ptxas, p2_ptxas = [], {}, {}
    for name in kernels.SOURCES:
        lines = list(ptxas_lines(kernels.log_path(name).read_text(), kernels.nvcc_path()))
        for line in lines:
            print(f"  {name}: {line}", flush=True)
        faults += [f"{name}: {line}" for line in hopper_faults(lines)]
        if name in (fm.KERNEL, fm.KERNEL_BWD):
            b4_ptxas[name] = registers_and_spills(lines, B4_BODIES)
        if name == mm.LIBRARY:
            p2_ptxas = registers_and_spills(
                lines, [body for bodies in P2_BODIES.values() for body in bodies])
    if faults:
        fail("a Hopper body spills or has its wgmma serialised:\n" + "\n".join(faults))
    if set(B4_BODIES) != {body for bodies in fm.HOPPER_BODIES.values() for body in bodies}:
        fail(f"B4_BODIES {B4_BODIES} are not the wrapper's {fm.HOPPER_BODIES}")
    if P2_BODIES != mm.HOPPER_BODIES:
        fail(f"P2_BODIES {P2_BODIES} are not the wrapper's {mm.HOPPER_BODIES}")

    train_errors = phase_kernels(torch, fa)
    mlp_errors = phase_mlp_kernels(torch, fm)
    masked_errors = phase_masked_kernels(torch, mm)
    fused_errors = phase_fused_kernels(torch, fa)
    blockwise_errors = phase_blockwise_kernels(torch, fb)
    with tempfile.TemporaryDirectory() as tmp:
        server, x, unfused_out, serve_launches = phase_serving(torch, fa, tmp)
        serve_stats = phase_serving_times(torch, fa, server, x, card)
        del server
        fused_serve_launches = phase_serving_fused(torch, fa, fm, tmp, x,
                                                   unfused_out, card)
    state, train_step, batch, train_launches, warm_ms = phase_training(torch, fa)
    train_stats = phase_training_times(torch, fa, state, train_step, batch,
                                       warm_ms, card)
    del state, train_step, batch
    fused_train_launches = phase_training_fused(torch, fa, fm, warm_ms, card)
    scan_paths = phase_scan(torch, fa, card)
    with tempfile.TemporaryDirectory() as tmp:
        trainer_launches, resumed_launches, trainer_stats, dino_eval, straight, handoff = \
            phase_trainer(torch, fa, card, warm_ms, tmp)
        orbax_paths = phase_orbax_resume(torch, fa, card, tmp, straight, handoff,
                                         resumed_launches)
        del handoff
        preempt_paths = phase_preempt(torch, fa, card, tmp, straight)
        dp_paths, dp_stats = phase_data_parallel(torch, fa, card, tmp, straight,
                                                 trainer_stats)
        del straight
        standalone_launches = phase_standalone_eval(torch, fa, card, Path(tmp) / "run",
                                                    dino_eval)
        dino_eval_launches = dino_eval["launches"]
        del dino_eval
        umap_vis_launches, umap_vis_s = phase_visualize_umap(torch, fa, card,
                                                             Path(tmp) / "run", tmp)
        finetune_launches = phase_finetune(torch, fa, card,
                                           Path(tmp) / "run" / "best_model", tmp)
    with tempfile.TemporaryDirectory() as tmp:
        host_launches = phase_host_multicrop(torch, fa, card, tmp, trainer_stats)
    with tempfile.TemporaryDirectory() as tmp:
        jpeg_paths = phase_jpeg_folder(torch, fa, card, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        (simmim_fit_launches, simmim_resumed_launches, simmim_state, simmim_optimizer,
         simmim_batch, _, simmim_eval_launches) = phase_simmim_trainer(torch, fa, card, tmp)
        accum_paths = phase_grad_accum(torch, fa, card, simmim_state, simmim_optimizer,
                                       simmim_batch)
        simmim_serve_launches, _ = phase_simmim_serving(torch, fa, card, simmim_state, tmp)
        del simmim_state, simmim_batch
        simmim_vis_launches, simmim_vis_s = phase_visualize_simmim(
            torch, fa, card, Path(tmp) / "simmim", tmp)
    simmim_b1_rows = phase_b1_simmim_times(torch, fa, card)
    mlp_stats = phase_mlp_times(torch, fm, card)
    blocks = VIT_B16_384["model"]["num_blocks"]
    with tempfile.TemporaryDirectory() as tmp:
        sup_serve_launches = phase_supervised_serving(
            torch, fa, tmp, card, VIT_B16_384, {fa.FUSED_KERNEL: blocks})
    sup_paths = phase_supervised_training(
        torch, fa, card, VIT_B16_384,
        {fa.FUSED_KERNEL_TRAIN: blocks, fa.FUSED_KERNEL_BWD: blocks},
        {fa.FUSED_KERNEL: blocks}, "")
    with tempfile.TemporaryDirectory() as tmp:
        sup_fused_serve_launches = phase_supervised_serving(
            torch, fa, tmp, card, VIT_B16_384_FUSED,
            {fa.FUSED_KERNEL: blocks, fm.KERNEL: blocks}, [no_plain_mlp(fm)], fused=True)
    sup_fused_paths = phase_supervised_training(
        torch, fa, card, VIT_B16_384_FUSED,
        {fa.FUSED_KERNEL_TRAIN: blocks, fa.FUSED_KERNEL_BWD: blocks,
         fm.KERNEL_TRAIN: blocks, fm.KERNEL_BWD: blocks},
        {fa.FUSED_KERNEL: blocks, fm.KERNEL: blocks}, "_fused", [no_plain_mlp(fm)],
        fused=True)
    fused_stats = phase_fused_times(torch, fa, card)
    with tempfile.TemporaryDirectory() as tmp:
        sup512_serve_launches = phase_supervised_serving(
            torch, fa, tmp, card, VIT_B16_512, {fb.KERNEL: blocks})
    sup512_paths = phase_supervised_training(
        torch, fa, card, VIT_B16_512,
        {fb.KERNEL: blocks, fb.KERNEL_DQ: blocks, fb.KERNEL_DKV: blocks},
        {fb.KERNEL: blocks}, "_512",
        profiled={body: 3 * blocks for body in B2_BWD_BODIES.values()},
        absent=B2_MMA_SYNC_BODIES)
    blockwise_stats = phase_blockwise_times(torch, fb, card)
    ring_paths, ring_stats = phase_ring(torch, fb, card)
    tp_paths, tp_stats = phase_tensor_parallel(torch, fa, fb, fm, card)
    tp_rows = phase_tp_times(torch, fa, fb, fm, card, {
        "b1": train_errors, "b4": mlp_errors, "b3": fused_errors, "b2": blockwise_errors})
    pipe_paths, pipe_stats = phase_pipeline(torch, fa, fb, fm, card)
    probe_launches, p1_stats, p1_err = phase_exp2_probe(torch, fb, card)
    masked_stats = phase_masked_times(torch, mm, card)
    dropout_probe_launches, _ = phase_dropout_probe(torch, fm, mm, card)
    vit_b_rows = phase_b1_vit_b_times(torch, fa, card)
    with tempfile.TemporaryDirectory() as tmp:
        vit_b_launches, vit_b_resumed_launches, _ = phase_vit_b_trainer(torch, fa, card, tmp)
        attention_vis_launches, attention_vis_s = phase_visualize_attention(
            torch, fa, card, Path(tmp) / "vit_b", tmp)
    batch1_rows = phase_b1_batch1_times(torch, fa, card)
    present = {name: importlib.util.find_spec(name) is not None
               for name in ("rich", "matplotlib", "PIL")}
    print(f"== visualizers on {card}: wall seconds through main: attention map "
          f"{attention_vis_s:.3f}, SimMIM reconstruction {simmim_vis_s:.3f}, 3D UMAP "
          f"{umap_vis_s:.3f}; host packages installed here (the live training view "
          f"and the figures): {present}", flush=True)
    remat_paths = phase_remat(torch, fa, card)
    with tempfile.TemporaryDirectory() as tmp:
        moe_paths = phase_moe(torch, fa, card, tmp)
    patch_paths = phase_patch_dropout(torch, fa, card)
    patch_b1_rows = phase_b1_patch_times(torch, fa, card)

    b, n, h, d, dtype_name, bs = ATTENTION_CASES[0]
    xq, xk, xv = qkv(b, n, h, d, getattr(torch, dtype_name), seed=200)
    ref = fa.attention_nhd_reference(xq, xk, xv, h, 1.0 / d ** 0.5, bs)
    out = fa.attention_nhd(xq, xk, xv, h, 1.0 / d ** 0.5, bs)
    serve_err = float((out.float() - ref.float()).abs().max())

    globals_case = TRAIN_CASES[0]
    # B1's forwards: the served batch's and the student globals' shapes, each
    # with the other main-path shapes of its entry (the teacher's; the packed
    # locals) listed beside
    locals_case = TRAIN_CASES[2]
    # and ViT-B/16's 224-px shape (the training forward's output is
    # bit-equal to the inference kernel's, so both carry its error)
    vit_b_err = train_errors[VIT_B_B1_CASE]
    # and SimMIM's (128, 144) shape, checked as a training case
    simmim_err = train_errors[SIMMIM_B1_CASE]
    # and ViT-B/16's patch-dropout shape (1024, 99), a training case
    patch_err = train_errors[PATCH_B1_CASE]
    entries = [
        (fa.KERNEL, "attention_fwd_sm90.cuh", "vit_ssl_tpu/ops/flash_attention.py:352",
         serve_err, {**serve_stats, "at_other_shapes": [
             train_stats[("fwd_inference", 0)],
             {**vit_b_rows["fwd"], "max_abs_err": vit_b_err[0]},
             {**simmim_b1_rows["fwd"], "max_abs_err": simmim_err[0]},
             *batch1_rows]}),
        (fa.KERNEL_TRAIN, "attention_fwd_sm90.cuh", "vit_ssl_tpu/ops/flash_attention.py:352",
         train_errors[globals_case][0],
         {**train_stats[("fwd", 0)], "data_parallel": dp_stats, "at_other_shapes": [
             {**train_stats[("fwd", locals_case[-1])],
              "max_abs_err": train_errors[locals_case][0]},
             {**vit_b_rows["fwd_stats"], "max_abs_err": vit_b_err[0]},
             {**simmim_b1_rows["fwd_stats"], "max_abs_err": simmim_err[0]},
             {**patch_b1_rows["fwd_stats"], "max_abs_err": patch_err[0]}]}),
        (fa.KERNEL_BWD, "attention_bwd_sm90.cuh", "vit_ssl_tpu/ops/flash_attention.py:392",
         train_errors[globals_case][1],
         {**train_stats[("bwd", 0)],
          "entry_source": "vit_ssl_tpu_torch/csrc/attention_nhd_bwd.cu",
          "at_other_shapes": [{**train_stats[("bwd", locals_case[-1])],
                               "max_abs_err": train_errors[locals_case][1]},
                              {**vit_b_rows["bwd"], "max_abs_err": vit_b_err[1]},
                              {**simmim_b1_rows["bwd"], "max_abs_err": simmim_err[1]},
                              {**patch_b1_rows["bwd"], "max_abs_err": patch_err[1]}]}),
    ]
    # B4 at each width: the served forward (no mask), the training forward
    # and the backward (keep-mask); the backward's max_abs_err is dx's: the
    # weight gradients sum over T rows and are held to a relative bar, so
    # they are listed apart
    for (d_model, d_ff), serve_rows, train_rows in ((MLP_DIMS, MLP_ROWS[2], MLP_ROWS[0]),
                                                    (VIT_B_MLP, 36928, 36928),
                                                    (VIT_L_MLP, 12608, 12608)):
        errs = {dt: mlp_errors[(rows, d_model, d_ff, "bfloat16")]
                for dt, rows in (("serve", serve_rows), ("train", train_rows))}
        width = {"d_model": d_model}
        # the bf16 kernels each entry runs, with their ptxas registers and
        # spills (the library that holds them)
        hopper = {entry: {"bodies": list(fm.HOPPER_BODIES[entry]), "ptxas": {
            kernel: row for kernel, row in b4_ptxas[library].items()
            if any(body in kernel for body in fm.HOPPER_BODIES[entry])}}
            for entry, library in ((fm.KERNEL, fm.KERNEL), (fm.KERNEL_TRAIN, fm.KERNEL),
                                   (fm.KERNEL_BWD, fm.KERNEL_BWD))}
        entries += [
            (fm.KERNEL, "mlp_gemm_sm90.cuh", "vit_ssl_tpu/ops/fused_mlp.py:72",
             errs["serve"]["fwd"], {**mlp_stats[("fwd", serve_rows, d_model)], **width,
                                    "entry_source": "vit_ssl_tpu_torch/csrc/fused_mlp_fwd.cu",
                                    **hopper[fm.KERNEL]}),
            (fm.KERNEL_TRAIN, "mlp_gemm_sm90.cuh", "vit_ssl_tpu/ops/fused_mlp.py:93",
             errs["train"]["fwd_pre"], {**mlp_stats[("fwd_pre", train_rows, d_model)],
                                        **width,
                                        "entry_source": "vit_ssl_tpu_torch/csrc/fused_mlp_fwd.cu",
                                        **hopper[fm.KERNEL_TRAIN]}),
            (fm.KERNEL_BWD, "mlp_gemm_sm90.cuh", "vit_ssl_tpu/ops/fused_mlp.py:182",
             errs["train"]["bwd_abs"]["dx"],
             {**mlp_stats[("bwd", train_rows, d_model)], **width,
              "entry_source": "vit_ssl_tpu_torch/csrc/fused_mlp_bwd.cu", **hopper[fm.KERNEL_BWD],
              "max_abs_err_by_output": errs["train"]["bwd_abs"],
              "max_rel_err_by_output": errs["train"]["bwd_rel"]}),
        ]
    vit_case = FUSED_CASES[0]
    entries += [
        (fa.FUSED_KERNEL, "attention_fwd_sm90.cuh",
         "vit_ssl_tpu/ops/flash_attention.py:60", fused_errors[vit_case][0],
         fused_stats["fwd"]),
        (fa.FUSED_KERNEL_TRAIN, "attention_fwd_sm90.cuh",
         "vit_ssl_tpu/ops/flash_attention.py:60", fused_errors[vit_case][0],
         fused_stats["fwd_stats"]),
        (fa.FUSED_KERNEL_BWD, "attention_bwd_sm90.cuh",
         "vit_ssl_tpu/ops/flash_attention.py:150", fused_errors[vit_case][1],
         fused_stats["bwd"]),
    ]
    b2_case = blockwise_errors[BLOCKWISE_CASES[0]]
    entries += [
        (fb.KERNEL, "flash_blockwise_fwd_sm90.cuh", "vit_ssl_tpu/ops/flash_blockwise.py:76",
         b2_case["fwd"], {**blockwise_stats["fwd"], "lse_max_abs_err": b2_case["lse"],
                          "ring": ring_stats}),
        (fb.KERNEL_DQ, "attention_bwd_sm90.cuh", "vit_ssl_tpu/ops/flash_blockwise.py:217",
         b2_case["dq"], {**blockwise_stats["dq"], "ring": ring_stats}),
        (fb.KERNEL_DKV, "attention_bwd_sm90.cuh", "vit_ssl_tpu/ops/flash_blockwise.py:168",
         b2_case["dkv"], {**blockwise_stats["dkv"], "ring": ring_stats}),
        (fb.KERNEL_EXP2, "flash_blockwise_fwd_sm90.cuh", "scripts/exp2_probe.py:27",
         p1_err, p1_stats),
    ]
    # P2 at the probe's shape, ViT-B/16's FFN beside it; the backward's
    # max_abs_err is dh's, the weight gradients listed apart; each entry's
    # bf16 kernels with their ptxas registers and spills
    p2_rows = {}
    for part, name in (("fwd", mm.KERNEL), ("bwd", mm.KERNEL_BWD)):
        rows = []
        for t, d_ff, _ in (MASKED_CASES[0], MASKED_CASES[3]):
            errs = masked_errors[(t, d_ff, "bfloat16")]
            err = errs["fwd"] if part == "fwd" else errs["bwd_abs"]["dh"]
            rows.append({**masked_stats[(part, t)], "max_abs_err": err, **(
                {} if part == "fwd" else {"max_abs_err_by_output": errs["bwd_abs"],
                                          "max_rel_err_by_output": errs["bwd_rel"]})})
        p2_rows[name] = (rows[0].pop("max_abs_err"), {
            **rows[0], "entry_source": "vit_ssl_tpu_torch/csrc/masked_matmul.cu",
            "bodies": list(mm.HOPPER_BODIES[name]),
            "ptxas": {kernel: row for kernel, row in p2_ptxas.items()
                      if any(body in kernel for body in mm.HOPPER_BODIES[name])},
            "at_other_shapes": rows[1:]})
    entries += [
        (mm.KERNEL, "masked_matmul.cu", "scripts/dropout_epilogue_probe.py:60",
         *p2_rows[mm.KERNEL]),
        (mm.KERNEL_BWD, "masked_matmul.cu", "scripts/dropout_epilogue_probe.py:69",
         *p2_rows[mm.KERNEL_BWD]),
    ]
    paths = {"serving": serve_launches, "training": train_launches,
             "trainer": trainer_launches, "trainer_resumed": resumed_launches,
             "host_multicrop": host_launches,
             "dino_evaluation": dino_eval_launches,
             "evaluate_standalone": standalone_launches,
             "simmim_evaluation": simmim_eval_launches,
             "finetune": finetune_launches, "trainer_vit_b": vit_b_launches,
             "trainer_vit_b_resumed": vit_b_resumed_launches, **remat_paths,
             "simmim_trainer": simmim_fit_launches,
             "simmim_trainer_resumed": simmim_resumed_launches,
             "simmim_serve": simmim_serve_launches, **accum_paths,
             "serving_fused": fused_serve_launches, "training_fused": fused_train_launches,
             "serving_supervised": sup_serve_launches, **sup_paths,
             "serving_supervised_fused": sup_fused_serve_launches, **sup_fused_paths,
             "serving_supervised_512": sup512_serve_launches, **sup512_paths,
             "exp2_probe": probe_launches, "dropout_epilogue_probe": dropout_probe_launches,
             **preempt_paths, **scan_paths, **moe_paths, **patch_paths,
             **dp_paths, **ring_paths, **tp_paths, **pipe_paths, **jpeg_paths,
             **orbax_paths,
             "visualizer_attention": attention_vis_launches,
             "visualizer_simmim": simmim_vis_launches,
             "visualizer_umap_3d": umap_vis_launches}
    # the paths that run B4 at each width (ViT-L's 1024 runs on none yet)
    width_paths = {MLP_DIMS[0]: ("serving_fused", "training_fused", "dropout_epilogue_probe"),
                   VIT_B_MLP[0]: ("serving_supervised_fused", "training_supervised_fused",
                                  "eval_supervised_fused"),
                   VIT_L_MLP[0]: ()}
    # each kernel of the tensor-parallel phase at its tp-local shapes (B4: the
    # 384 entries), the phase's checks beside B1's training forward
    for name, _, _, _, stats in entries:
        if name in tp_rows and stats.get("d_model", MLP_DIMS[0]) == MLP_DIMS[0]:
            stats["tp_local_shapes"] = tp_rows[name]
        if name == fa.KERNEL_TRAIN:
            stats["tensor_parallel"] = tp_stats
            stats["pipeline"] = pipe_stats
    for name, _, _, _, stats in entries:
        if sum(p.get(name, 0) for p in paths.values()) == 0:
            fail(f"{name} was not launched on the main paths")
        if "d_model" in stats:
            stats["launches_at_d_model"] = sum(paths[path].get(name, 0)
                                               for path in width_paths[stats["d_model"]])
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"vit_ssl_tpu_torch/csrc/{source}",
        "replaces": replaces,
        "launches": sum(p.get(name, 0) for p in paths.values()),
        "launches_by_path": {path: p.get(name, 0) for path, p in paths.items()},
        "max_abs_err": err,
        **stats,
    } for name, source, replaces, err, stats in entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
