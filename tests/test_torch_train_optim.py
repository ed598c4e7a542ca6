"""The port's TBPTT step against ``evflow.train.make_train_step`` under the
other optimizers (AdamW, SGD with momentum, RMSprop; the clip active), the
other two ``remat`` policies (none, dots: the same gradients and one
running-statistics update a pass), and ``learn_leak`` / ``learn_thresh``
false with ``detach`` false, on LIFFireNet_short at the sizes and bars of
``tests/test_torch_train_step.py`` (its first case's seed and window)."""

import numpy as np
import pytest

import _torch_train as T
from evflow_torch.probes.train_step import spike_margins

SEED, SKIP = 1, 3
CASES = {
    "adamw": dict(optimizer={"name": "AdamW", "lr": 1e-3, "weight_decay": 0.01}),
    "sgd": dict(optimizer={"name": "SGD", "lr": 1e-2, "momentum": 0.9}),
    "rmsprop": dict(optimizer={"name": "RMSprop", "lr": 1e-3}),
    "remat_none": dict(remat="none"),
    "remat_dots": dict(remat="dots"),
    "frozen_lif": dict(spiking_neuron={"leak": [0.0, 1.0], "thresh": [0.0, 0.8],
                                       "learn_leak": False, "learn_thresh": False,
                                       "detach": False}),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return T.make_data(tmp_path_factory.mktemp("optim"))


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_reference(data, case):
    kw = dict(CASES[case])
    sn = kw.pop("spiking_neuron", None)
    cfg = T.train_config(data, **kw)
    if sn is not None:
        cfg["model"]["spiking_neuron"] = sn
    v = T.seeded(cfg, SEED)
    window = T.loss_window(cfg, SKIP)
    jloss, jvars, jgrads = T.jax_step(cfg, v, window)
    with spike_margins() as margins:
        loss, model, grads, _ = T.port_step(cfg, v, window)
    T.check_margins(margins)
    assert np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values())) > 1.0
    np.testing.assert_allclose(loss, jloss, rtol=T.LOSS_RTOL)
    T.assert_grads_match(grads, jgrads, v)
    T.assert_step_matches(model, cfg, v, jvars, jgrads)
    if case == "frozen_lif":
        for key, g in grads.items():
            if key.endswith(("lif.beta", "lif.threshold")):
                assert not g.any(), key
                np.testing.assert_array_equal(model.state_dict()[key].numpy(),
                                              T.in_port_layout(v)[key].numpy())
