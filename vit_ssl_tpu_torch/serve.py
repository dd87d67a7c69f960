"""Serving CLI of the port: class predictions or DINO and SimMIM embeddings.

Port of ``scripts/serve.py`` for supervised, finetune, SimMIM and DINO
checkpoints. The checkpoint is a checkpoint directory, as ``scripts/serve.py``
takes it (a JAX run's ``best_model``, its orbax tree read by the port's own
reader, or a port run's), or the reference-layout ``.pth`` that
``scripts/export_torch.py`` writes from a JAX run (``model_state_dict``
plus the embedded ``config``); the weights are loaded with ``strict=True``:

- supervised / finetune: the whole :class:`~vit_ssl_tpu_torch.models.ViT`,
  answering the argmax class and its softmax probability;
- dino: the teacher backbone (or the student's, when there is no teacher)
  in a :class:`~vit_ssl_tpu_torch.models.ViTBackbone`, answering its CLS
  embedding; head and center are not used;
- simmim: the whole :class:`~vit_ssl_tpu_torch.models.SimMIMViT`, answering
  the mean of its patch features from the unmasked forward
  (``inference_forward``), as the JAX package's evaluators embed SimMIM.

Serving mechanics: one forward at a static batch shape (short batches are
zero-padded, pad rows dropped on output), the checkpoint's compute dtype,
a warm-up at start-up with the warm batch time reported, and an optional
micro-batching stdin server that flushes a batch when it fills or when the
oldest request has waited ``--max-wait-ms``. Attention runs through the
hand-written CUDA kernels on the card (B1, or B3 for ViT-B/16 at 384 px).

    python -m vit_ssl_tpu_torch.serve --checkpoint model.pth img1.png img2.png
    python -m vit_ssl_tpu_torch.serve --checkpoint <run>/best_model img1.png
    python -m vit_ssl_tpu_torch.serve --checkpoint model.pth --input-dir imgs/
    ... | python -m vit_ssl_tpu_torch.serve --checkpoint model.pth --stdin

Output is JSON lines: {"path", "pred", "prob"} for classifiers,
{"path", "embedding"} for DINO and SimMIM (``--no-embedding-values`` emits the
vector's L2 norm instead); an input that fails to decode gives
{"path", "error"}.
"""

from __future__ import annotations

import argparse
import json
import os
import select
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .data.datasets import _load_image
from .data.transforms import Compose, Resize, ToTensor
from .device import resolve_device
from .models.builder import (build_backbone, build_simmim, build_vit, config_mode,
                             load_state_any_layout)
from .utils.checkpoint import backbone_state_dict, load_checkpoint, load_pth


def load_serving_state(checkpoint: str):
    """(reference-layout state dict, metadata) of a ``.pth`` or of a
    checkpoint directory of either package (DINO's teacher and student as
    ``teacher_*`` and ``student_*`` keys, a model's own keys)."""
    if not os.path.isdir(checkpoint):
        return load_pth(checkpoint)
    tree, metadata = load_checkpoint(checkpoint)
    if "model" in tree:
        return tree["model"], metadata
    state = {f"student_{k}": v for k, v in tree["student"].items()}
    state.update({f"teacher_{k}": v for k, v in tree["teacher"].items()})
    return state, metadata


def make_pipeline(img_size: int) -> Compose:
    """The evaluators' clean inference pipeline: Resize + ToTensor."""
    return Compose([Resize([img_size, img_size]), ToTensor()])


class Server:
    """Static-shape batched inference with zero-padding."""

    def __init__(self, checkpoint: str, batch_size: int,
                 embedding_values: bool = True, device=None):
        self.device = resolve_device(device)
        state, metadata = load_serving_state(checkpoint)
        if "config" not in metadata:
            raise ValueError(f"{checkpoint} embeds no config")
        self.config = metadata["config"]
        self.mode = config_mode(self.config)
        self.classifier = self.mode in ("supervised", "finetune")
        if self.classifier:
            self.model = build_vit(self.config, self.device)
            load_state_any_layout(self.model, state)
        elif self.mode == "simmim":
            self.model = build_simmim(self.config, self.device)
            load_state_any_layout(self.model, state)
        else:
            self.model = build_backbone(self.config, self.device)
            load_state_any_layout(self.model, backbone_state_dict(state))
        self.model.eval()
        self.forward = (self.model.inference_forward if self.mode == "simmim"
                        else self.model)
        self.embedding_values = embedding_values
        self.img = int(self.config["data"]["img_size"])
        self.batch = int(batch_size)
        self.pipeline = make_pipeline(self.img)

        zeros = np.zeros((self.batch, self.img, self.img, 3), np.float32)
        t0 = time.perf_counter()
        self.forward_batch(zeros)
        self.first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.forward_batch(zeros)
        self.warm_s = time.perf_counter() - t0
        print(
            f"[serve] mode={self.mode} device={self.device} img={self.img} "
            f"batch={self.batch} first batch {self.first_s:.1f}s, warm batch "
            f"{self.warm_s * 1e3:.1f} ms "
            f"({self.batch / max(self.warm_s, 1e-9):.0f} img/s)",
            file=sys.stderr, flush=True,
        )

    def forward_batch(self, x: np.ndarray) -> np.ndarray:
        """(n, img, img, 3) float32 NHWC, n ≤ batch → (n, num_classes)
        logits (classifiers) or (n, embed_dim) embeddings (DINO's CLS
        token, SimMIM's mean patch feature), float32.

        Short batches are zero-padded to the static batch; the pad rows are
        dropped from the result. Returns after the device has finished."""
        n = len(x)
        if n > self.batch:
            raise ValueError(f"{n} images exceed the batch size {self.batch}")
        xb = torch.zeros((self.batch, self.img, self.img, 3), dtype=torch.float32)
        xb[:n] = torch.from_numpy(np.asarray(x, np.float32))
        with torch.inference_mode():
            out = self.forward(xb.to(self.device))[:n].float().cpu().numpy()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def _decode(self, path: str) -> np.ndarray:
        """The image at ``path`` through the clean pipeline, decoded as the
        JAX package's server decodes it (PIL's ``convert("RGB")``: no EXIF
        rotation, PIL's CMYK): PNG, JPEG and BMP without OpenCV or PIL,
        other formats with one of them."""
        return self.pipeline(_load_image(path, reference="pil"))

    def infer(self, paths):
        """Forward a (possibly short) list of paths; returns one result dict
        per input, in order. A path that fails to decode yields an
        ``{"path", "error"}`` record: one bad request must not take down the
        batch (or, in --stdin mode, the server)."""
        good, images, records = [], [], [None] * len(paths)
        for i, p in enumerate(paths):
            try:
                images.append(self._decode(p))
                good.append(i)
            except Exception as e:  # any decode failure becomes a record
                records[i] = {"path": str(p), "error": f"{type(e).__name__}: {e}"}
        if good:
            out = self.forward_batch(np.stack(images))
            for row, i in enumerate(good):
                records[i] = self._format(paths[i], out[row])
        return records

    def _format(self, path, out_row):
        if self.classifier:
            e = np.exp(out_row - out_row.max())
            return {"path": str(path), "pred": int(out_row.argmax()),
                    "prob": round(float((e / e.sum()).max()), 6)}
        if not self.embedding_values:
            return {"path": str(path),
                    "embedding_norm": round(float(np.linalg.norm(out_row)), 6)}
        return {"path": str(path),
                "embedding": [round(float(v), 6) for v in out_row]}


def run_stdin_server(server: Server, sink, max_wait_ms: float, stdin=None):
    """Micro-batching loop: flush when the batch fills, when the oldest
    queued request has waited ``max_wait_ms``, or at EOF.

    Reads the fd unbuffered (``os.read`` + manual line assembly): mixing
    ``select()`` with buffered ``readline()`` deadlocks when a client writes
    several lines in one chunk."""
    fd = (stdin if stdin is not None else sys.stdin).fileno()
    pending: list = []
    oldest = None
    buf = b""
    eof = False

    def flush():
        nonlocal pending, oldest
        if pending:
            for rec in server.infer(pending):
                sink.write(json.dumps(rec) + "\n")
            sink.flush()
            pending, oldest = [], None

    while True:
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            path = line.decode().strip()
            if path:
                pending.append(path)
                oldest = oldest if oldest is not None else time.monotonic()
            if len(pending) >= server.batch:
                flush()
        if eof:
            tail = buf.decode().strip()  # final line without a newline
            if tail:
                pending.append(tail)
            flush()
            return
        timeout = None
        if oldest is not None:
            timeout = max(0.0, max_wait_ms / 1e3 - (time.monotonic() - oldest))
        ready, _, _ = select.select([fd], [], [], timeout)
        if not ready:
            flush()  # the oldest request hit its latency budget
            continue
        chunk = os.read(fd, 65536)
        if not chunk:
            eof = True
            continue
        buf += chunk


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("--checkpoint", required=True,
                        help="a checkpoint directory (a JAX or port run's best_model) "
                        "or a .pth written by scripts/export_torch.py")
    parser.add_argument("paths", nargs="*", help="image files")
    parser.add_argument("--input-dir", help="serve every image in a directory")
    parser.add_argument("--stdin", action="store_true",
                        help="micro-batching server: image paths on stdin")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--max-wait-ms", type=float, default=50.0,
                        help="stdin mode: max queueing latency before a "
                        "short batch is flushed")
    parser.add_argument("--output", help="write JSON lines here instead of stdout")
    parser.add_argument("--no-embedding-values", action="store_true",
                        help="emit embedding L2 norms instead of full vectors")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu for the plain PyTorch path")
    args = parser.parse_args(argv)

    paths = list(args.paths)
    if args.input_dir:
        exts = {".png", ".jpg", ".jpeg", ".bmp"}
        paths += sorted(
            str(p) for p in Path(args.input_dir).iterdir()
            if p.suffix.lower() in exts
        )
    if not paths and not args.stdin:
        parser.error("no inputs: pass image paths, --input-dir, or --stdin")

    server = Server(args.checkpoint, args.batch_size,
                    embedding_values=not args.no_embedding_values,
                    device=args.device)
    sink = open(args.output, "w") if args.output else sys.stdout
    try:
        if args.stdin:
            run_stdin_server(server, sink, args.max_wait_ms)
        else:
            t0 = time.perf_counter()
            n = 0
            for i in range(0, len(paths), server.batch):
                for rec in server.infer(paths[i:i + server.batch]):
                    sink.write(json.dumps(rec) + "\n")
                    n += 1
            sink.flush()
            dt = time.perf_counter() - t0
            print(f"[serve] {n} images in {dt:.2f}s ({n / max(dt, 1e-9):.0f} "
                  "img/s end-to-end incl. decode)", file=sys.stderr, flush=True)
    finally:
        if args.output:
            sink.close()


if __name__ == "__main__":
    main()
