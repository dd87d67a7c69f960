"""Kernel B4's bf16 bodies as wgmma/TMA products (``csrc/mlp_gemm_sm90.cuh``).

What this host can check without a card: both B4 libraries rebuild when
the products' header or the Hopper pieces under it change (``kernels.py``
reads each source's includes), and so does P2's, whose bf16 kernels run
the same product; every kernel that the wrapper
(``ops/fused_mlp.py::HOPPER_BODIES``) and ``chip_smoke.py``
(``B4_BODIES``) name for the bf16 entries is a kernel of that header; the
bf16 mma.sync row and weight kernels and their ldmatrix fragment helpers
are gone from ``csrc/fused_mlp_common.cuh`` and ``csrc/weight_grad.cuh``
while the fp32 bodies stay; and the port's ``fused_mlp`` (its plain
versions on the CPU) against the JAX package's in interpret mode at
DINO ViT-S/8's width and the ragged token counts 1 and 70, at the
tolerances ``tests/test_torch_fused_mlp.py`` states. The kernels
themselves are held against the plain versions on the card
(``tests/test_torch_cuda_kernels.py``).
"""

import ast
import re
from pathlib import Path

import pytest

from test_torch_fused_mlp import _assert_matches_jax
from vit_ssl_tpu_torch import kernels
from vit_ssl_tpu_torch.ops import fused_mlp as fm

ROOT = Path(__file__).resolve().parents[1]
HEADER = kernels.CSRC_DIR / "mlp_gemm_sm90.cuh"


def _chip_smoke_bodies():
    """The ``B4_BODIES`` tuple of ``chip_smoke.py``, read without importing
    the script."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(target, "id", None) == "B4_BODIES" for target in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no B4_BODIES")


@pytest.mark.parametrize("library", [fm.KERNEL, fm.KERNEL_BWD])
def test_b4_libraries_rebuild_on_the_hopper_headers(library):
    files = {f.name for f in kernels.source_files(library)}
    assert {"mlp_gemm_sm90.cuh", "sm90_common.cuh", "fused_mlp_common.cuh"} <= files


def test_p2_library_does_not_include_the_hopper_products():
    """P2 (``masked_matmul``) runs B4's wgmma/TMA product with h masked on
    its way in: the products' header and the Hopper pieces under it rebuild
    its library, and so does ``weight_grad.cuh`` (the ordered reduction of
    its weight gradient's slices, its fp32 weight kernel)."""
    files = {f.name for f in kernels.source_files("masked_matmul")}
    assert {"mlp_gemm_sm90.cuh", "sm90_common.cuh", "weight_grad.cuh"} <= files


def _header_kernels():
    """The __global__ kernels the header defines, by name."""
    return set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                          r"(\w+_sm90_kernel)\s*\(", HEADER.read_text()))


@pytest.mark.parametrize("entry", sorted(fm.HOPPER_BODIES))
def test_wrapper_bodies_are_kernels_of_the_header(entry):
    bodies = fm.HOPPER_BODIES[entry]
    assert bodies and set(bodies) <= _header_kernels(), (entry, bodies)


def test_chip_smoke_bodies_are_the_wrappers_and_the_headers():
    listed = _chip_smoke_bodies()
    assert set(listed) == {b for bodies in fm.HOPPER_BODIES.values() for b in bodies}
    assert set(listed) == _header_kernels()


def test_forward_entries_share_their_kernels():
    """The inference and training forwards run the same two products, so
    their outputs are equal bit for bit."""
    assert fm.HOPPER_BODIES[fm.KERNEL] == fm.HOPPER_BODIES[fm.KERNEL_TRAIN]


def test_no_bf16_row_kernel_remains():
    """The mma.sync bf16 row kernel and its tiles are gone from the shared
    header, and so are the ldmatrix fragment helpers that only P2's old
    products and the bf16 weight kernel took; the fp32 row kernel stays.
    ``weight_grad.cuh`` keeps its fp32 weight kernel and the ordered
    reduction that both backwards' bf16 weight products end in."""
    common = (kernels.CSRC_DIR / "fused_mlp_common.cuh").read_text()
    for gone in ("mlp_rows_bf16", "RowTile", "kMlpThreads", "mma_bf16(", "load_w2",
                 "load_a(", "load_b(", "frag_split_"):
        assert gone not in common, gone
    for kept in ("mlp_rows_f32", "gelu_grad"):
        assert kept in common, kept
    weights = (kernels.CSRC_DIR / "weight_grad.cuh").read_text()
    assert "mlp_weights_bf16" not in weights and "mask_bf16x8" not in weights
    assert "mlp_weights_f32" in weights and "reduce_splits" in weights
    assert '#include "weight_grad.cuh"' in (kernels.CSRC_DIR / "masked_matmul.cu").read_text()


def test_hopper_bodies_are_launched_from_the_c_entries():
    """The bf16 branches of both C entries launch the header's bodies."""
    fwd = (kernels.CSRC_DIR / "fused_mlp_fwd.cu").read_text()
    bwd = (kernels.CSRC_DIR / "fused_mlp_bwd.cu").read_text()
    assert "sm90::mlp_forward" in fwd and "mlp_rows_bf16" not in fwd
    assert "sm90::mlp_backward" in bwd and "reduce_splits" in bwd
    header = HEADER.read_text()
    for body in _header_kernels():
        assert re.search(rf"launch_gemm\(\s*{body}\b", header), body


@pytest.mark.parametrize("with_mask", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 70])
def test_fused_mlp_matches_jax_at_dino_width_and_ragged_t(t, dtype, with_mask):
    """DINO ViT-S/8's FFN (384 -> 1536) at T = 1 and T = 70: rows that fill
    no 128-row tile, the ragged edges where the Hopper bodies' TMA loads
    zero-fill and their TMA stores write nothing."""
    _assert_matches_jax(dtype, with_mask, t=t, d_in=384, d_ff=1536, seed=13 + t)
