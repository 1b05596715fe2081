"""The port's token pipeline against ``repro.data``: batches bit for bit
the reference's for the same (seed, step), then the reference's own
checks (tests/test_data.py) on the port."""
import numpy as np
import pytest

from repro.configs import base as ref_configs
from repro.data import DataConfig as RefDataConfig
from repro.data import TokenPipeline as RefPipeline
from repro_torch.configs import base as configs
from repro_torch.data import DataConfig, TokenPipeline


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("step", [0, 7])
def test_batches_equal_the_reference(arch, step):
    for seq, batch, seed in ((32, 8, 1234), (17, 3, 5)):
        got = TokenPipeline(configs.get_reduced(arch), seq, batch,
                            DataConfig(seed=seed)).global_batch_at(step)
        want = RefPipeline(ref_configs.get_reduced(arch), seq, batch,
                           RefDataConfig(seed=seed)).global_batch_at(step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_multicodebook_and_vlm_batches_equal_the_reference():
    """The codebook and image branches, on configs rebuilt field by field
    from the reference's reduced ones."""
    for name in ("musicgen_medium", "llama_3_2_vision_90b"):
        rcfg = ref_configs.get_reduced(name)
        cfg = configs.ArchConfig(**{f: getattr(rcfg, f) for f in
                                    rcfg.__dataclass_fields__})
        got = TokenPipeline(cfg, 16, 2).global_batch_at(3)
        want = RefPipeline(rcfg, 16, 2).global_batch_at(3)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_batches_deterministic():
    cfg = configs.get_reduced("smollm_135m")
    p1 = TokenPipeline(cfg, 32, 8)
    p2 = TokenPipeline(cfg, 32, 8)
    b1 = p1.global_batch_at(5)
    np.testing.assert_array_equal(b1["tokens"], p2.global_batch_at(5)[
        "tokens"])
    assert not np.array_equal(p1.global_batch_at(6)["tokens"], b1["tokens"])


def test_labels_are_shifted_tokens():
    p = TokenPipeline(configs.get_reduced("smollm_135m"), 32, 4)
    b = p.global_batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_shard_slices_partition_global_batch():
    p = TokenPipeline(configs.get_reduced("llama3_8b"), 16, 8)
    g = p.global_batch_at(0)
    parts = [p.shard_slice(g, i, 4) for i in range(4)]
    np.testing.assert_array_equal(
        np.concatenate([x["tokens"] for x in parts], axis=0), g["tokens"])


def test_state_roundtrip_resumes_stream():
    cfg = configs.get_reduced("smollm_135m")
    p = TokenPipeline(cfg, 16, 4)
    next(p)
    next(p)
    state = p.state_dict()
    b3 = next(p)
    q = TokenPipeline(cfg, 16, 4)
    q.load_state_dict(state)
    np.testing.assert_array_equal(next(q)["tokens"], b3["tokens"])
    assert state == RefPipeline(ref_configs.get_reduced("smollm_135m"), 16,
                                4).state_dict() | {"step": 2}
