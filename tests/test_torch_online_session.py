"""The port's frame-in / phase-out ``OnlineSession`` on the CPU at the tiny
preset of tests/test_online.py (64-px wire frames, one torch thread):

- against the port's own offline composition (extraction at batch 1, then
  the offline MS-TCN, MS-TCN + refiner, or Mamba) at atol 1e-4 (read at
  most 3.6e-7), the features equal;
- against the JAX package's ``OnlineSession`` on the same weights (the
  backbone's drawn by the port and carried to JAX by the JAX importer, as in
  tests/test_torch_mit_graph.py; the temporal models' seeded in the port and
  carried across by the JAX importers of ``surgical_tpu/models/convert.py``)
  and frames. The two backbones run other
  graphs here, as each package's CPU default picks: the port's serving graph
  in bf16 (the kernels' plain versions), JAX's flax graph. The features are
  held to the correlation bound of tests/test_torch_slice.py (> 0.999;
  read 0.999985), the logits to 5e-2 (read: 8.3e-5 MS-TCN, 1.3e-2
  MS-TCN + refiner, 5.9e-3 Mamba, on logits up to 1.9);
- the temporal + refiner leg (``advance``) fed JAX's own session features,
  against JAX's session logits at 1e-4 (read at most 6e-7);
- the flow-missing refusal, ``reset`` and ``frame_idx``, and the refusal of
  a temporal or refiner model on another device than the backbone's;
- chip_smoke.py's session phase at this size.
"""

import dataclasses

import numpy as np
import pytest
import torch

from surgical_tpu.core.config import (BackboneConfig, HeadConfig, MambaConfig, MSTCNConfig,
                                      RefinerConfig)
from surgical_tpu.models.mamba import CausalMambaModel as JaxMamba
from surgical_tpu.models.mstcn import MultiStageTCN as JaxMSTCN
from surgical_tpu.models.transsv import RefinementTransformer as JaxRefiner
from surgical_tpu.serving import online as jonline
from surgical_tpu.models.convert import (import_mamba_state_dict, import_mstcn_state_dict,
                                         import_refiner_state_dict)
from surgical_tpu_torch.models.convert import load_evp_params
from surgical_tpu_torch.models.mamba import CausalMambaModel
from surgical_tpu_torch.models.mit_evp import MiTEVP
from surgical_tpu_torch.models.mstcn import MultiStageTCN
from surgical_tpu_torch.models.transsv import RefinementTransformer
from surgical_tpu_torch.serving.online import (OnlineMamba, OnlineMSTCN, OnlineRefiner,
                                               OnlineSession)
from surgical_tpu_torch.train.extract import extract_features, make_raw_feature_fn
from surgical_tpu_torch.train.refiner import predict_video
from test_torch_mit_graph import jax_variables

S, T, E = 64, 5, 16
CFG = BackboneConfig.preset("tiny")
HEAD = HeadConfig(embedding_dim=E, hidden=8)
MSTCN = MSTCNConfig(stages=2, layers=3, f_maps=8, f_dim=E)
REFINER = RefinerConfig(f_maps=8, f_dim=E, len_q=4)
MAMBA = MambaConfig(f_dim=E, d_model=16, d_state=8, layers=2)
ATOL = 1e-4
FEATURE_CORR, LOGIT_ATOL = 0.999, 5e-2
KINDS = ("mstcn", "mstcn_refiner", "mamba")


@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(1)
    variables = jax_variables(CFG, HEAD, seed=0)
    backbone = MiTEVP(CFG, HEAD, device="cpu")
    load_evp_params(backbone, variables["params"], variables["batch_stats"])
    port = {
        "mstcn": MultiStageTCN(MSTCN, seed=1, device="cpu"),
        "mamba": CausalMambaModel(MAMBA, seed=2, device="cpu"),
        "refiner": RefinementTransformer(REFINER, seed=3, device="cpu"),
    }
    sd = {k: {n: v.numpy() for n, v in m.state_dict().items()} for k, m in port.items()}
    jax_models = {
        "mstcn": (JaxMSTCN(MSTCN), import_mstcn_state_dict(sd["mstcn"], MSTCN.stages,
                                                           MSTCN.layers)),
        "mamba": (JaxMamba(MAMBA), import_mamba_state_dict(sd["mamba"], MAMBA.layers)),
        "refiner": (JaxRefiner(REFINER), import_refiner_state_dict(sd["refiner"],
                                                                   REFINER.n_layers)),
    }
    return variables, backbone, jax_models, port


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(3)
    return (rng.integers(0, 255, (T, S, S, 3), dtype=np.uint8),
            rng.integers(0, 255, (T, S, S, 1), dtype=np.uint8),
            rng.standard_normal((T, S, S, 2)).astype(np.float16))


def _session(kind, backbone, port):
    temporal = (OnlineMamba if kind == "mamba" else OnlineMSTCN)(port[kind.split("_")[0]])
    refiner = OnlineRefiner(port["refiner"]) if kind.endswith("refiner") else None
    return OnlineSession(backbone, temporal, refiner=refiner)


def _stream(session, frames):
    return np.stack([session.step(*(a[t] for a in frames)) for t in range(T)])


@pytest.mark.parametrize("kind", KINDS)
def test_session_matches_port_offline(models, frames, kind):
    _, backbone, _, port = models
    session = _session(kind, backbone, port)
    online = _stream(session, frames)
    assert session.frame_idx == T and online.shape == (T, 14)

    batches = [tuple(a[t:t + 1] for a in frames) for t in range(T)]
    feats, _ = extract_features(make_raw_feature_fn(backbone), batches, T, E, batch_size=1)
    session.reset()
    streamed = np.stack([session.features(*(a[t] for a in frames)).numpy() for t in range(T)])
    np.testing.assert_array_equal(streamed, feats)
    lfb = torch.from_numpy(feats)
    with torch.no_grad():
        if kind.endswith("refiner"):
            offline = predict_video(port["mstcn"], port["refiner"], lfb)
        else:
            offline = port[kind](lfb[None])[-1, 0]
    np.testing.assert_allclose(online, offline.numpy(), rtol=0, atol=ATOL)


def _jax_session(kind, variables, jax_models):
    from surgical_tpu.models.mit_evp import MiTEVP as JaxMiTEVP

    name = kind.split("_")[0]
    model, params = jax_models[name]
    temporal = (jonline.OnlineMamba if name == "mamba" else jonline.OnlineMSTCN)(model, params)
    refiner = (jonline.OnlineRefiner(*jax_models["refiner"]) if kind.endswith("refiner")
               else None)
    return jonline.OnlineSession(JaxMiTEVP(CFG, HEAD), variables, temporal, refiner=refiner)


@pytest.mark.parametrize("kind", KINDS)
def test_session_matches_jax_session(models, frames, kind):
    variables, backbone, jax_models, port = models
    jsession = _jax_session(kind, variables, jax_models)
    session = _session(kind, backbone, port)
    want_feats = np.stack([np.asarray(jsession._feature_fn(*(a[t:t + 1] for a in frames))[0],
                                      np.float32) for t in range(T)])
    want = _stream(jsession, frames)
    got_feats = np.stack([session.features(*(a[t] for a in frames)).numpy() for t in range(T)])
    got = _stream(session, frames)
    assert np.corrcoef(got_feats.ravel(), want_feats.ravel())[0, 1] > FEATURE_CORR
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)

    # the temporal + refiner leg alone, fed JAX's own session features
    session.reset()
    chained = np.stack([session.advance(torch.from_numpy(f)).numpy() for f in want_feats])
    assert session.frame_idx == T
    np.testing.assert_allclose(chained, want, rtol=0, atol=ATOL)


def test_flow_reset_and_devices(models, frames):
    _, backbone, _, port = models
    session = _session("mstcn_refiner", backbone, port)
    img, seg, flow = (a[0] for a in frames)
    with pytest.raises(ValueError, match="with_flow=True"):
        session.step(img, seg, None)
    assert session.frame_idx == 0
    first = session.step(img, seg, flow)
    session.step(img, seg, flow)
    assert session.frame_idx == 2
    session.reset()
    assert session.frame_idx == 0
    np.testing.assert_array_equal(session.step(img, seg, flow), first)

    # a backbone without flow fusion serves without a flow frame
    noflow = MiTEVP(dataclasses.replace(CFG, with_flow=False), HEAD, device="cpu")
    out = OnlineSession(noflow, OnlineMSTCN(port["mstcn"])).step(img, seg, None)
    assert out.shape == (14,) and np.isfinite(out).all()

    # temporal or refiner parameters on another device than the backbone's
    elsewhere = MultiStageTCN(MSTCN, device="meta")
    with pytest.raises(ValueError, match="session moves nothing"):
        OnlineSession(backbone, OnlineMSTCN(elsewhere))
    with pytest.raises(ValueError, match="refiner model"):
        OnlineSession(backbone, OnlineMSTCN(port["mstcn"]),
                      refiner=OnlineRefiner(RefinementTransformer(REFINER, device="meta")))


def test_chip_smoke_session_phase_on_cpu():
    """chip_smoke.py's session phase, sized down to the tiny variant on the
    CPU (nothing timed or counted there): the same checks as on the card."""
    import chip_smoke

    res = chip_smoke.phase_online_session(device="cpu", cfg=CFG, head_cfg=HEAD, size=S,
                                          frames=8, batch=8)
    for row in res.values():
        assert row["logit_err"] <= chip_smoke.SESSION_LOGIT_BOUND
        assert row["cos_min"] >= chip_smoke.SESSION_COS_BOUND
