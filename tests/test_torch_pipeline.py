"""The port's LM data pipeline against the JAX package's.

``batch_for_step`` must give the same arrays, bit for bit, for the token
(granite-3-2b), audio (hubert-xlarge) and vision (paligemma-3b) configs;
then the cases of tests/test_pipeline.py on the port's pipeline: per-step
determinism, shifted labels, the prefetcher against direct generation,
and its rewind after a restart.
"""

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tpipe


def _cfgs(name):
    return (jconfigs.reduced_config(jconfigs.get_config(name)),
            tconfigs.reduced_config(tconfigs.get_config(name)))


@pytest.mark.parametrize("name", ["granite-3-2b", "hubert-xlarge",
                                  "paligemma-3b"])
@pytest.mark.parametrize("step,seed,batch", [(0, 0, None), (7, 3, 5)])
def test_batch_for_step_bit_identical_to_jax(name, step, seed, batch):
    jcfg, tcfg = _cfgs(name)
    want = jpipe.batch_for_step(jcfg, jcfg.shapes[0], step, seed=seed,
                                batch_override=batch)
    got = tpipe.batch_for_step(tcfg, tcfg.shapes[0], step, seed=seed,
                               batch_override=batch)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert tpipe.NOISE == jpipe.NOISE


def test_batch_deterministic_per_step():
    cfg = _cfgs("granite-3-2b")[1]
    a = tpipe.batch_for_step(cfg, cfg.shapes[0], 5)
    b = tpipe.batch_for_step(cfg, cfg.shapes[0], 5)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    c = tpipe.batch_for_step(cfg, cfg.shapes[0], 6)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_labels_are_shifted_tokens():
    cfg = _cfgs("granite-3-2b")[1]
    b = tpipe.batch_for_step(cfg, cfg.shapes[0], 0)
    assert b["tokens"].shape == b["labels"].shape
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_prefetcher_matches_direct():
    cfg = _cfgs("granite-3-2b")[1]
    pf = tpipe.Prefetcher(cfg, cfg.shapes[0], start=0, depth=2)
    try:
        for step in range(4):
            got = pf.get(step)
            ref = tpipe.batch_for_step(cfg, cfg.shapes[0], step)
            np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_rewind_after_restart():
    cfg = _cfgs("granite-3-2b")[1]
    pf = tpipe.Prefetcher(cfg, cfg.shapes[0], start=3, depth=2)
    try:
        pf.get(3)
        pf.get(4)
        got = pf.get(3)  # a restart rewinds to step 3
        ref = tpipe.batch_for_step(cfg, cfg.shapes[0], 3)
        np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    finally:
        pf.close()
