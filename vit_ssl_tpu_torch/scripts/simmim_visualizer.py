"""SimMIM reconstruction of one image (after the repo's
``scripts/simmim_visualizer.py``): the model its checkpoint's config
builds, a masked forward with dropout off, and the original / masked /
reconstruction triptych, the predicted patches pasted into the masked grid
positions.

The mask is :func:`..models.simmim.make_random_mask` on
``torch.Generator().manual_seed(seed)``; the JAX script draws it from
``jax.random.PRNGKey(seed)``, so the two scripts mask different patches
for the same seed (``mask`` takes an injected one). The figure is drawn
where matplotlib imports; without it one warning names the skipped file
and the images are still returned.

    python -m vit_ssl_tpu_torch.scripts.simmim_visualizer --checkpoint <run>/best_model \\
        --image photo.png [--output simmim_reconstruction.png] [--seed 0] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Tuple

import numpy as np
import torch

from .attention_visualizer import load_image, load_model_from_checkpoint

logger = logging.getLogger(__name__)

TITLES = ("Original", "Masked", "Reconstruction")


def reconstruction_arrays(model, config, image_path: str, seed: int = 0,
                          mask: Optional[torch.Tensor] = None
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(original, masked, reconstruction) float32 HWC images of
    ``image_path`` through ``model`` on its device; ``mask`` (1, N) bool is
    used as given, else drawn from ``seed``."""
    from ..models.simmim import make_random_mask
    from ..ops import extract_patches, patches_to_image

    img_size = int(config["data"]["img_size"])
    patch = int(config["model"]["patch_size"])
    channels = int(config["model"]["in_channels"])
    image = load_image(image_path, img_size)
    x = torch.as_tensor(image)[None]
    if mask is None:
        mask = make_random_mask(torch.Generator().manual_seed(seed), 1,
                                (img_size // patch) ** 2, float(config["model"]["mask_ratio"]))
    device = next(model.parameters()).device
    with torch.inference_mode():
        preds, _, bool_mask = model(x.to(device), deterministic=True, mask=mask)
    preds = np.clip(preds.float().cpu().numpy(), 0, 1)
    bool_mask = bool_mask[0].cpu().numpy()

    def image_of(patches):
        return patches_to_image(torch.from_numpy(patches), (img_size, img_size), patch,
                                channels)[0].numpy()

    patches = extract_patches(x, patch).float().numpy()
    masked = patches.copy()
    masked[0, bool_mask] = 0.5  # masked patches mid-grey
    recon = patches.copy()
    recon[0, bool_mask] = preds[0, bool_mask]
    return image, image_of(masked), image_of(recon)


def draw(images, mask_ratio: float, output_path: str) -> bool:
    """The triptych in ``output_path``; False (one warning) where
    matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        logger.warning("matplotlib is not installed: skipped the figure %s", output_path)
        return False
    fig, axes = plt.subplots(1, 3, figsize=(13, 5))
    for ax, img, title in zip(axes, images, TITLES):
        ax.imshow(np.clip(img, 0, 1))
        ax.set_title(title)
        ax.axis("off")
    fig.suptitle(f"SimMIM reconstruction (mask ratio {mask_ratio:.2f})")
    fig.tight_layout()
    fig.savefig(output_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    print(f"saved {output_path}")
    return True


def visualize_simmim_reconstruction(model, config, image_path: str, output_path: str,
                                    seed: int = 0, mask: Optional[torch.Tensor] = None):
    """The three images, the figure drawn where it can be."""
    images = reconstruction_arrays(model, config, image_path, seed, mask)
    draw(images, float(config["model"]["mask_ratio"]), output_path)
    return images


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s | %(levelname)s | %(message)s")
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--image", required=True)
    parser.add_argument("--output", default="simmim_reconstruction.png")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)

    model, config = load_model_from_checkpoint(args.checkpoint, args.device)
    return visualize_simmim_reconstruction(model, config, args.image, args.output,
                                           args.seed)


if __name__ == "__main__":
    main()
