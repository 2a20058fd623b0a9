"""How the port's flash-attention backward picks and feeds its kernels,
checked on the CPU without a launch: the variant per dtype, the input-copy
decision per variant (pure tensor inspection), and the build's naming of
the kernel libraries by their sources and the header they share. The
kernels themselves are held against the plain backward on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import pytest
import torch

from trlx_tpu_torch.ops import flash_attention as tflash


@pytest.mark.parametrize(
    "dtype, variant", [(torch.bfloat16, "tile"), (torch.float32, "fma")], ids=str
)
def test_backward_variant_by_dtype(dtype, variant):
    """bf16 takes the tensor-core tile kernels, f32 the FMA parity path (on
    the tensor cores it would be TF32); the C entry points take the
    variant's code."""
    assert tflash.backward_variant(dtype) == variant
    assert tflash.BACKWARD_VARIANTS[variant] == {"fma": 0, "tile": 1}[variant]


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8], ids=str)
def test_backward_variant_refuses_other_dtypes(dtype):
    with pytest.raises(ValueError, match="unsupported dtype"):
        tflash.backward_variant(dtype)


SHAPE = (2, 5, 3, 64)  # [B, T, H, D]


def _views(kind):
    """Five bf16 [B, T, H, D] views (q, k, v, o, dO) of one layout."""
    n = 2 * 5 * 3 * 64
    if kind == "contiguous":
        return [torch.randn(SHAPE).bfloat16() for _ in range(5)]
    if kind == "packed":  # GPT-2's fused projection: q/k/v share rows of 3 * 192
        qkv = torch.randn(2, 5, 3 * 192).bfloat16()
        q, k, v = (t.view(SHAPE) for t in qkv.split(192, dim=-1))
        return [q, k, v, torch.randn(SHAPE).bfloat16(), torch.randn(SHAPE).bfloat16()]
    if kind == "misaligned_base":  # contiguous, 2 bytes past an allocation
        return [torch.randn(n + 1).bfloat16()[1:].view(SHAPE) for _ in range(5)]
    if kind == "odd_row_stride":  # row stride 196: no multiple of 8 elements
        return [torch.randn(2, 5, 192 + 4).bfloat16()[..., :192].unflatten(-1, (3, 64))
                for _ in range(5)]
    if kind == "last_dim_strided":
        return [torch.randn(2, 5, 64, 3).bfloat16().transpose(-1, -2) for _ in range(5)]
    raise KeyError(kind)


@pytest.mark.parametrize(
    "kind, tile_copies, fma_copies",
    [("contiguous", 0, 0), ("packed", 0, 0), ("misaligned_base", 5, 0),
     ("odd_row_stride", 5, 0), ("last_dim_strided", 5, 5)],
)
@pytest.mark.parametrize("variant", ["tile", "fma"])
def test_backward_kernel_inputs_copy_what_the_variant_cannot_read(
    variant, kind, tile_copies, fma_copies
):
    """The tile variant reads q, k, v, o and dO with 16-byte loads, so a
    view at a misaligned base or with a row stride that is no multiple of 8
    elements is copied; the fma variant needs only a contiguous last dim.
    A view read in place is passed through as it is; a copy is aligned,
    contiguous and equal."""
    views = _views(kind)
    out, copies = tflash.backward_kernel_inputs(variant, *views)
    assert copies == (tile_copies if variant == "tile" else fma_copies)
    for before, after in zip(views, out):
        assert torch.equal(before, after)
        if after is not before:
            assert after.is_contiguous() and tflash.aligned_for_16_byte_loads(after)
    assert sum(a is not b for a, b in zip(views, out)) == copies


def test_library_names_follow_the_shared_header(tmp_path, monkeypatch):
    """A library is named by the hash of its source and the header both
    sources include, so editing the header rebuilds both."""
    names = {n: tflash._library_path(n) for n in tflash.SOURCES}
    header = tmp_path / "hopper_tile.cuh"
    with open(tflash.HEADER, "rb") as fh:
        header.write_bytes(fh.read() + b"\n// edited\n")
    monkeypatch.setattr(tflash, "HEADER", str(header))
    for name, path in names.items():
        assert tflash._library_path(name) != path


@pytest.mark.parametrize("Q, K", [(1, 576), (9, 130), (16, 65), (17, 150), (112, 112),
                                  (130, 300), (1024, 1024)])
def test_visit_rule_is_row_at_or_past_the_key_tile(Q, K):
    """K3's tile kernel applies the causal visit rule per row as ``qi >= k0``
    (``csrc/flash_bwd.cu``): a key tile starts at a multiple of 64, which
    is a multiple of both forward query tiles (16, 64), so it starts
    before the end of row qi's forward tile exactly when it starts at or
    before qi."""
    tile_start = torch.arange(K) // tflash.KEY_TILE * tflash.KEY_TILE
    rule = torch.arange(Q)[:, None] >= tile_start[None, :]
    assert torch.equal(tflash.visited_keys(Q, K), rule)
