"""The port's analytic cost model (repro_torch.launch.roofline_model)
against the reference's on every configuration x input shape, the
counterparts of test_roofline_model.py's analytic tests and of
test_optflags.py's flag parsing, and the H100 constants."""
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import list_configs  # noqa: E402
from repro.launch import roofline_model as jrm  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import optflags  # noqa: E402
from repro_torch.launch import roofline_model as rm  # noqa: E402
from repro_torch.serving.kv_cache import cache_bytes  # noqa: E402

REL = 1e-12


@pytest.fixture(autouse=True)
def _clean_flags():
    optflags.set_flags([])
    yield
    optflags.set_flags([])


def _close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b))


@pytest.mark.parametrize("arch", list_configs())
def test_terms_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, ish in INPUT_SHAPES.items():
        jish = JSHAPES[name]
        assert _close(rm.analytic_flops(cfg, ish),
                      jrm.analytic_flops(jcfg, jish)), name
        tokens = ish.global_batch * ish.seq_len
        assert _close(rm.linear_flops(cfg, tokens),
                      jrm.linear_flops(jcfg, tokens)), name
        for n in (1, 256, 512):
            assert _close(rm.analytic_bytes(cfg, ish, n, 2),
                          jrm.analytic_bytes(jcfg, jish, n)), (name, n)
            # fp32 weights and activations read more, never less
            assert rm.analytic_bytes(cfg, ish, n, 4) > \
                rm.analytic_bytes(cfg, ish, n, 2)


def test_analytic_flops_close_to_6nd_for_dense_train():
    cfg = get_config("tinyllama-1.1b")
    ish = INPUT_SHAPES["train_4k"]
    got = rm.analytic_flops(cfg, ish)
    model = 6.0 * cfg.active_param_count() * ish.global_batch * ish.seq_len
    # implemented program does full-S^2 attention -> got >= model flops
    assert model * 0.8 < got < model * 2.5


def test_decode_flops_scale_with_batch_not_seq():
    cfg = get_config("tinyllama-1.1b")
    d32 = INPUT_SHAPES["decode_32k"]
    f = rm.analytic_flops(cfg, d32)
    # decode processes B tokens; linear part = 2*N*B
    lin = rm.linear_flops(cfg, d32.global_batch)
    assert f > lin                      # + attention over the 32k cache
    assert f < lin * 10


def test_analytic_bytes_decode_dominated_by_cache_and_weights():
    cfg = get_config("deepseek-67b")
    ish = INPUT_SHAPES["decode_32k"]
    b = rm.analytic_bytes(cfg, ish, 256)
    w = cfg.param_count() * 2 / 256
    kv = cache_bytes(cfg, ish.global_batch, ish.seq_len) / 256
    assert 0.9 * (w + kv) < b < 1.5 * (w + kv)


def test_causal_skip_term_equals_reference():
    """Under ``causal_skip`` the port's query-block loop skips the blocks
    above the diagonal, and its count is the reference's (Skv / 2 + 256
    keys per query on full causal self-attention), for every config and
    shape; it lowers the train count of a full-attention model."""
    from repro.launch import optflags as joptflags
    cfg = get_config("tinyllama-1.1b")
    ish = INPUT_SHAPES["train_4k"]
    before = rm.analytic_flops(cfg, ish)
    try:
        optflags.set_flags(["causal_skip"])
        joptflags.set_flags(["causal_skip"])
        assert rm.analytic_flops(cfg, ish) < before
        for arch in list_configs():
            for name, ish in INPUT_SHAPES.items():
                assert _close(rm.analytic_flops(get_config(arch), ish),
                              jrm.analytic_flops(jget_config(arch),
                                                 JSHAPES[name])), (arch,
                                                                   name)
    finally:
        joptflags.set_flags([])


def test_flag_parsing():
    optflags.set_flags(["resident_weights", "microbatches=4"])
    assert optflags.has("resident_weights")
    assert not optflags.has("flat_dp")
    assert optflags.get_int("microbatches", 16) == 4
    assert optflags.get_int("missing", 7) == 7


def test_h100_terms():
    """The roofline terms divide by the H100's published peaks."""
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.PEAK_FLOPS_FP32, tmesh.HBM_BW,
            tmesh.NVLINK_BW, tmesh.HBM_BYTES) == \
        (989e12, 67e12, 3.35e12, 450e9, 80e9)
    t = rm.roofline_terms(67e12, 3.35e12, 450e9, tmesh.PEAK_FLOPS_FP32)
    assert t == {"compute_s": 1.0, "memory_s": 1.0, "collective_s": 1.0}
