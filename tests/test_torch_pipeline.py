"""The port's one-device GPipe schedule (repro_torch.parallel.pipeline)
against the sequential loop it must equal, mirroring the stage function of
tests/test_pipeline_multidev.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.parallel.pipeline import pipeline_apply, split_microbatches  # noqa: E402


@pytest.mark.parametrize("n_stages,n_micro", [(4, 4), (4, 2), (1, 3), (3, 5)])
def test_pipeline_matches_sequential(n_stages, n_micro):
    rng = np.random.default_rng(0)
    d, mb = 16, 3
    ws = [torch.from_numpy(rng.standard_normal((d, d)) * 0.3) for _ in range(n_stages)]
    x = torch.from_numpy(rng.standard_normal((n_micro * mb, d)))
    calls = [0] * n_stages

    def stage(i_w, h):
        i, w = i_w
        calls[i] += 1
        return torch.tanh(h @ w)

    out = pipeline_apply(stage, list(enumerate(ws)), split_microbatches(x, n_micro))
    ref = x
    for w in ws:
        ref = torch.tanh(ref @ w)
    assert out.shape == (n_micro, mb, d)
    torch.testing.assert_close(out.reshape(-1, d), ref)
    assert calls == [n_micro + n_stages - 1] * n_stages


def test_split_microbatches():
    x = torch.arange(24.0).reshape(6, 4)
    mbs = split_microbatches(x, 3)
    assert mbs.shape == (3, 2, 4)
    torch.testing.assert_close(mbs.reshape(6, 4), x)
    with pytest.raises(ValueError, match="microbatches"):
        split_microbatches(x, 4)
    with pytest.raises(ValueError, match="microbatches"):
        split_microbatches(x, 0)
