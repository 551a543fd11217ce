"""``layers.LocalDraw``, the per-rank init of a sharded run: a rank's part
of a leaf is bitwise the slice of the one-process draw from the same
seed, and the generator ends where the whole draw leaves it.  On the CPU
every draw is made; on a CUDA generator a draw outside the part only
moves the Philox offset (marked ``cuda``: run it on the card with
``python -m pytest -m cuda tests``).  This file imports no JAX."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import layers as tlayers  # noqa: E402


def _local_draws(monkeypatch, device):
    """(a part drawn by ``LocalDraw``, the same part of the whole draw,
    the draws each made, the generators after them): a (2, 6, 20, 30)
    leaf drawn one (20, 30) matrix at a time, of which the part is rows
    [2, 4) of its second dimension, so 4 of its 12 draws."""
    sizes, real = [], torch.randn

    def spy(*shape, **kw):
        out = real(*shape, **kw)
        sizes.append(out.numel())
        return out
    monkeypatch.setattr(tlayers, "_DRAW_ELEMS", 1000)
    monkeypatch.setattr(torch, "randn", spy)
    shape = (2, 6, 20, 30)
    region = ((0, 2), (2, 4), (0, 20), (0, 30))
    whole_gen = torch.Generator(device).manual_seed(5)
    whole = tlayers._normal(whole_gen, shape, torch.float32, 0.5)
    n_whole = len(sizes)
    sizes.clear()
    draw = tlayers.LocalDraw(torch.Generator(device).manual_seed(5),
                             lambda axes, full: region)
    part = tlayers._dense_init(draw, shape[1:], torch.float32,
                               ("a", "b", "c"), scale=0.5, stack=shape[0])
    want = whole[tuple(slice(a, b) for a, b in region)]
    return part, want, (n_whole, len(sizes)), (whole_gen, draw.gen)


def test_local_draw_is_the_slice_on_the_cpu(monkeypatch):
    """On a CPU generator (no offset to move) ``LocalDraw`` makes every
    draw of the whole leaf and keeps its part: bitwise the slice, and the
    generator ends where the whole draw's does."""
    part, want, (n_whole, n_part), (g_whole, g_part) = _local_draws(
        monkeypatch, "cpu")
    assert n_whole == n_part == 12
    assert torch.equal(part, want)
    assert torch.equal(torch.randn(8, generator=g_part),
                       torch.randn(8, generator=g_whole))


@pytest.mark.cuda
def test_local_draw_skips_foreign_draws_on_the_card(monkeypatch):
    """On a CUDA generator ``LocalDraw`` makes only the draws its part
    needs (the first draw of a size is made, to read the offset it moves
    the generator on), yet the part is bitwise the slice of the whole
    draw and the generator ends at the whole draw's offset."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CPU generator has no offset")
    part, want, (n_whole, n_part), (g_whole, g_part) = _local_draws(
        monkeypatch, "cuda")
    assert n_whole == 12 and n_part == 1 + 4
    assert torch.equal(part, want)
    assert g_part.get_offset() == g_whole.get_offset()
