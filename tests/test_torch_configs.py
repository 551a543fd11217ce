"""The port's config registry against the JAX package's: the same ten
architectures in the same order, each config and its smoke config equal
field for field (dtype names included), and the torch dtypes the port
derives from those names."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402

ARCHS = jconfigs.all_archs()


def test_registry_lists_every_reference_config():
    assert tconfigs.all_archs() == ARCHS and len(ARCHS) == 10
    assert tconfigs.ALIASES == jconfigs.ALIASES


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_field_for_field(arch, smoke):
    get_j = jconfigs.get_smoke if smoke else jconfigs.get
    get_t = tconfigs.get_smoke if smoke else tconfigs.get
    want = dataclasses.asdict(get_j(arch))
    got = dataclasses.asdict(get_t(arch))
    assert got == want
    cfg = get_t(arch)
    assert cfg.pdtype == getattr(torch, cfg.param_dtype)
    assert cfg.cdtype == getattr(torch, cfg.compute_dtype)
    assert cfg.d_head == get_j(arch).d_head
    assert cfg.n_params() == get_j(arch).n_params()


def test_dash_aliases_resolve():
    assert tconfigs.get("paligemma-3b") == tconfigs.get("paligemma_3b")
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get("gpt2")
