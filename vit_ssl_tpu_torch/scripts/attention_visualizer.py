"""Attention map of a supervised ViT (after the repo's
``scripts/attention_visualizer.py``): the forward with ``return_attn=True``,
the CLS row of the last block's attention averaged over the heads, laid on
the patch grid, resized to the image with OpenCV's cubic rule
(:func:`..data.image_ops.resize`) and scaled to [0, 1], drawn over the
image with the predicted class in the title.

Every block but the last runs through the attention route (kernel B1 on
the card at 224 px); the last block's probabilities come from the plain
math, as in the JAX package. The figure is drawn where matplotlib imports;
without it one warning names the skipped file and the arrays are still
returned.

    python -m vit_ssl_tpu_torch.scripts.attention_visualizer --checkpoint <run>/best_model \\
        --image photo.png [--output attention_overlay.png] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from typing import Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


def load_model_from_checkpoint(checkpoint_path: str, device=None):
    """(model, config) of a checkpoint directory (``metadata.json`` beside
    the port's ``state.pt`` or a JAX run's orbax ``tree/``): the model its
    embedded config builds, on ``device`` (default the card), with the
    saved weights."""
    from ..config import from_container
    from ..device import resolve_device
    from ..models.builder import build_model
    from ..utils.checkpoint import load_checkpoint

    tree, metadata = load_checkpoint(checkpoint_path)
    config = from_container(metadata["config"])
    model = build_model(config, resolve_device(device))
    model.load_state_dict(tree["model"])
    model.eval()
    return model, config


def load_image(image_path: str, img_size: int) -> np.ndarray:
    """The image as the JAX script reads it: PIL's ``convert("RGB")``
    (the port's decoder, bit-equal to it), ``Resize([img, img])``,
    ``ToTensor``: float32 HWC in [0, 1]."""
    from ..data.datasets import _load_image
    from ..data.transforms import Compose, Resize, ToTensor

    pipeline = Compose([Resize([img_size, img_size]), ToTensor()])
    return pipeline(_load_image(image_path, reference="pil"), np.random.default_rng(0))


def process_attention(attn: np.ndarray, img_size: int, patch: int) -> np.ndarray:
    """(1, heads, N+1, N+1) probabilities → the (img, img) heat map: the
    CLS row averaged over the heads, the CLS column dropped, the patch grid
    resized (cubic) and scaled to [0, 1]."""
    from ..data.image_ops import resize

    cls_row = attn[0, :, 0, 1:].mean(axis=0)
    grid = img_size // patch
    heat = resize(cls_row.reshape(grid, grid), img_size, img_size, "cubic")
    return (heat - heat.min()) / (heat.max() - heat.min() + 1e-8)


def attention_arrays(model, config, image_path: str) -> Tuple[np.ndarray, int, np.ndarray]:
    """(image, predicted class, heat map) of ``image_path`` through
    ``model`` on its device."""
    img_size = int(config["data"]["img_size"])
    patch = int(config["model"]["patch_size"])
    image = load_image(image_path, img_size)
    device = next(model.parameters()).device
    with torch.inference_mode():
        logits, attn = model(torch.as_tensor(image)[None].to(device), return_attn=True)
    pred_class = int(np.argmax(logits[0].float().cpu().numpy()))
    heat = process_attention(attn.float().cpu().numpy(), img_size, patch)
    return image, pred_class, heat


def draw(image: np.ndarray, heat: np.ndarray, pred_class: int, output_path: str) -> bool:
    """The input and the overlay side by side in ``output_path``; False (one
    warning) where matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        logger.warning("matplotlib is not installed: skipped the figure %s", output_path)
        return False
    fig, axes = plt.subplots(1, 2, figsize=(10, 5))
    axes[0].imshow(image)
    axes[0].set_title("Input")
    axes[0].axis("off")
    axes[1].imshow(image)
    axes[1].imshow(heat, cmap="viridis", alpha=0.5)
    axes[1].set_title(f"CLS attention — predicted class {pred_class}")
    axes[1].axis("off")
    fig.tight_layout()
    fig.savefig(output_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    print(f"saved {output_path}")
    return True


def visualize(model, config, image_path: str, output_path: str) -> Tuple[int, np.ndarray]:
    """(predicted class, heat map), the figure drawn where it can be."""
    image, pred_class, heat = attention_arrays(model, config, image_path)
    draw(image, heat, pred_class, output_path)
    return pred_class, heat


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s | %(levelname)s | %(message)s")
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--image", required=True)
    parser.add_argument("--output", default="attention_overlay.png")
    parser.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)

    model, config = load_model_from_checkpoint(args.checkpoint, args.device)
    return visualize(model, config, args.image, args.output)


if __name__ == "__main__":
    main()
