"""Multi-session mapping in the port against the JAX package: component
files, the map export, loading a component and relocalising a new session
against it (the cases of tests/test_multisession.py, run on the port).

Session A is a straight corridor of 6 keyframes with random descriptors and
landmark snapshots, built once in numpy and put into both packages.  Where
the two are compared on a relocalisation, the JAX package's draws are
injected into the port: the permutation that seeds the bootstrapped
vocabulary (`bow.init_indices`) and the RANSAC hypotheses
(`ransac.sample_indices`, keyed by the frame id as the JAX package's
single-candidate verification keys them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2x_tpu.cameras import distortion as jdist
from okvis2x_tpu.cameras import pinhole as jpin
from okvis2x_tpu.frontend import bow as jbow
from okvis2x_tpu.frontend import descriptor as jdesc
from okvis2x_tpu.frontend import ransac as jransac
from okvis2x_tpu.graph import EstimatorConfig
from okvis2x_tpu.graph import FrameState as JFrameState
from okvis2x_tpu.graph import component as jcomp
from okvis2x_tpu.pipeline.vio import PipelineConfig
from okvis2x_tpu.pipeline.vio import VioPipeline as JVioPipeline
from okvis2x_tpu_torch import convert
from okvis2x_tpu_torch.core import se3np
from okvis2x_tpu_torch.frontend import bow, ransac
from okvis2x_tpu_torch.graph import component
from okvis2x_tpu_torch.graph.estimator import FrameState, SlidingWindowEstimator
from okvis2x_tpu_torch.ops import hamming
from okvis2x_tpu_torch.pipeline.vio import VioPipeline

torch.set_num_threads(1)

EST = dict(cap_frames=6, cap_landmarks=64, cap_obs=128, cap_imu_links=5, cap_rel_edges=8)
T_SC = np.array([[0, 0, 0, 0, 0, 0, 1.0]])
N_KF, N_KP, K_MATCH = 6, 80, 3
# session B's world frame against A's: 1.5 m lateral (0.3 m up), 0.1 rad yaw
OFFSET = se3np.se3_multiply(np.array([0, 1.5, 0.3, 0, 0, 0, 1.0]),
                            np.concatenate([[0, 0, 0], se3np.delta_q(np.array([0, 0, 0.1]))]))


def jcam():
    return jpin.make_pinhole(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640, height=480,
                             model=jdist.NONE)


def jpipe(**kw):
    return JVioPipeline([jcam()], T_SC, EstimatorConfig(**EST), PipelineConfig(vocab_k=32, **kw))


def tpipe(**kw):
    cam = convert.camera(jax.tree.map(np.asarray, jcam()))
    return VioPipeline([cam], T_SC, convert.estimator_config(EstimatorConfig(**EST)),
                       convert.pipeline_config(PipelineConfig(vocab_k=32, **kw)), device="cpu")


def stop(*pipes):
    """Stop the recognition workers the pipelines started."""
    for p in pipes:
        if p._lc_thread is not None:
            p._lc_queue.put(None)
            p._lc_thread.join(timeout=60.0)


def pose(x):
    return np.array([x, 0.0, 0.0, 0, 0, 0, 1.0])


def project(T_WS, pts):
    """Pixel coordinates and visibility of world points from body pose T_WS
    (the camera is the body), by the JAX package's camera."""
    p_C = se3np.se3_apply(se3np.se3_inverse(T_WS), pts)
    uv, ok = jpin.project(jcam(), jnp.asarray(p_C))
    return np.asarray(uv, np.float64), np.asarray(ok)


def session_a(seed=5):
    """Keyframe poses 2 m apart along x, landmarks about 5 m ahead of each
    (a side-looking corridor), random descriptors."""
    rng = np.random.default_rng(seed)
    frames = []
    for k in range(N_KF):
        T = pose(2.0 * k)
        pts = np.array([2.0 * k, 0, 5.0]) + rng.normal(scale=[2.0, 1.5, 0.8], size=(N_KP, 3))
        packed = rng.integers(0, 2**32, (N_KP, 12), dtype=np.uint64).astype(np.uint32)
        uv, ok = project(T, pts)
        frames.append(dict(T=T, pts=pts, packed=packed, ok=ok, uv=uv))
    return frames


def fill(pipe, frames, frame_cls, int32=False):
    """Session A's archived keyframes, odometry edges and keyframe records
    in `pipe` (records with int32 words, as the port keeps them, when
    `int32`)."""
    est = pipe.est
    for k, fr in enumerate(frames):
        est.archive_frames[k] = frame_cls(fid=k, timestamp=float(k), T_WS=fr["T"].copy(),
                                          sb=np.zeros(9), is_keyframe=True,
                                          pose_graph_frame=True)
        if k:
            T_ij = se3np.se3_multiply(se3np.se3_inverse(frames[k - 1]["T"]), fr["T"])
            est.archive_edges.append(dict(i=k - 1, j=k, T_ij=T_ij, sqrt_info=np.eye(6) * 100.0))
        packed = fr["packed"].view(np.int32) if int32 else fr["packed"]
        pipe.kf_records[k] = dict(t=float(k), packed=packed.copy(), valid=fr["ok"].copy(),
                                  uv=fr["uv"].copy(),
                                  lm_pos=np.where(fr["ok"][:, None], fr["pts"], np.nan),
                                  T_WS=fr["T"].copy(), path=2.0 * k)


def component_file(tmp_path, frames):
    pipe = jpipe()
    fill(pipe, frames, JFrameState)
    path = str(tmp_path / "session_a.npz")
    pipe.save_component(path)
    stop(pipe)
    return path


def session_b(pipe, frames, frame_cls, device=False):
    """Session B's first keyframe: at A's keyframe K_MATCH in the map frame,
    believed at OFFSET times that in its own; it sees A's landmarks from
    the true pose with A's descriptors.  Returns (true pose, record)."""
    a = frames[K_MATCH]
    T_true = a["T"]
    T_B = se3np.se3_multiply(OFFSET, T_true)
    pipe.est.frames.append(frame_cls(fid=0, timestamp=0.0, T_WS=T_B.copy(), sb=np.zeros(9),
                                     is_keyframe=True))
    pipe.est._next_fid = 1
    uv, ok = project(T_true, a["pts"])
    rec = dict(t=0.0, packed=a["packed"].copy(), valid=ok, uv=uv,
               lm_pos=np.full((N_KP, 3), np.nan), T_WS=T_B.copy(), path=0.0)
    if device:
        rec["packed_d"] = torch.as_tensor(a["packed"].view(np.int32).copy())
        rec["valid_d"] = torch.as_tensor(ok)
    pipe.kf_records[0] = rec
    return T_true, rec


def jax_init_indices(n, k, seed=0):
    return torch.as_tensor(np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n)[:k]))


def jax_sample_indices(generator, n_hyp, sample_size, n, device=None):
    """The JAX package's single-candidate draw: PRNGKey(frame id); the port
    seeds its generator with the frame id."""
    key = jax.random.PRNGKey(generator.initial_seed())
    idx = jransac._sample_indices(key, n_hyp, sample_size, jnp.asarray(np.asarray(n)))
    return torch.as_tensor(np.asarray(idx, np.int64), device=device)


def rot_err(qa, qb):
    return 2 * np.arccos(np.clip(abs(np.dot(qa, qb)), 0, 1))


# ------------------------------------------------- tests/test_multisession.py
@pytest.mark.parametrize("vocab_path,async_loop_closure", [(None, False), ("", True)],
                         ids=["shipped-vocab-sync", "bootstrapped-vocab-async"])
def test_component_roundtrip_and_reloc(tmp_path, vocab_path, async_loop_closure):
    """The port alone, with its own draws: a component loads as fixed
    negative-fid nodes (with the shipped vocabulary, as in the JAX test, or
    one bootstrapped from the component's descriptors), and session B's
    1.5 m / 0.1 rad offset collapses onto the map frame, through the
    in-line pose graph or the loop edge and the background optimisation."""
    frames = session_a()
    path = component_file(tmp_path, frames)
    pipe = tpipe(vocab_path=vocab_path, async_loop_closure=async_loop_closure)
    try:
        assert (pipe.vocab is None) == (vocab_path == "")
        assert pipe.load_component(path)
        assert pipe.vocab is not None
        if vocab_path == "":
            assert tuple(pipe.vocab.shape) == (32, 12) and not pipe._vocab_pretrained
        assert len(pipe.components) == 1 and len(pipe.components[0]["records"]) == N_KF
        neg = [f for f in pipe.est.archive_frames if f < 0]
        assert len(neg) == N_KF and all(pipe.est.archive_frames[f].pose_fixed for f in neg)
        T_true, rec = session_b(pipe, frames, FrameState, device=True)
        words = bow.assign_packed(rec["packed_d"], rec["valid_d"], pipe.vocab).numpy()
        assert pipe._attempt_relocalisation(0, words, rec)
        assert pipe.relocalised and pipe.n_relocalisations == 1
        assert not pipe._use_async_pr()  # components keep recognition on the frame thread
        if async_loop_closure:
            assert pipe.est.archive_edges[-1]["loop"] and pipe.est.archive_edges[-1]["j"] == 0
            pipe.full_graph.join()
        T_after = pipe.est.get_state(0).T_WS
        assert np.linalg.norm(T_after[:3] - T_true[:3]) < 0.2
        assert rot_err(T_after[3:7], T_true[3:7]) < 0.05
    finally:
        stop(pipe)


def test_reloc_requires_records(tmp_path):
    pipe = tpipe()
    pipe.est.archive_frames[0] = FrameState(fid=0, timestamp=0.0, T_WS=pose(0.0),
                                            sb=np.zeros(9), is_keyframe=True,
                                            pose_graph_frame=True)
    path = str(tmp_path / "bare.npz")
    component.save_component(path, pipe.est)  # no records
    pipe_b = tpipe()
    try:
        assert not pipe_b.load_component(path)
    finally:
        stop(pipe, pipe_b)


def test_import_component_frames_remaps_negative():
    pipe = tpipe()
    stop(pipe)
    est = pipe.est
    fid_map = est.import_component_frames(
        [0, 1], [10.0, 11.0], np.stack([pose(0.0), pose(1.0)]),
        [dict(i=0, j=1, T_ij=pose(1.0), sqrt_info=np.eye(6))], fixed=True)
    assert set(fid_map.values()) == {-1, -2}
    assert est.archive_frames[-1].pose_fixed
    e = est.archive_edges[-1]
    assert e["i"] == -1 and e["j"] == -2
    assert est.archive_frames[-1].timestamp < -1e5
    # a second component goes below the first
    assert set(est.import_component_frames([7], [3.0], pose(0.0)[None], []).values()) == {-3}


# ------------------------------------------------------ files of both packages
def test_component_files_interchangeable(tmp_path):
    """save_component of the same session in both packages writes the same
    arrays; each package's load_component reads the other's file."""
    frames = session_a()
    pj, pt = jpipe(), tpipe()
    stop(pj, pt)
    fill(pj, frames, JFrameState)
    fill(pt, frames, FrameState, int32=True)
    fj, ft = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    pj.save_component(fj)
    pt.save_component(ft)
    zj, zt = np.load(fj), np.load(ft)
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].dtype == zt[k].dtype, k
        np.testing.assert_array_equal(zj[k], zt[k], err_msg=k)
    for a, b in ((jcomp.load_component(ft), component.load_component(fj)),
                 (component.load_component(ft), jcomp.load_component(fj))):
        assert sorted(a) == sorted(b) and sorted(a["records"]) == sorted(b["records"])
        for f, r in a["records"].items():
            for k, v in r.items():
                np.testing.assert_array_equal(v, b["records"][f][k])
        assert [(e["i"], e["j"]) for e in a["edges"]] == [(e["i"], e["j"]) for e in b["edges"]]
        np.testing.assert_array_equal(a["frame_T_WS"], b["frame_T_WS"])


def test_save_map_text_equal(tmp_path):
    """save_map's .g2o pose graph and map file are the same text."""
    frames = session_a()
    pj, pt = jpipe(), tpipe()
    stop(pj, pt)
    fill(pj, frames, JFrameState)
    fill(pt, frames, FrameState, int32=True)
    rng = np.random.default_rng(1)
    hp = np.concatenate([rng.normal(size=(5, 3)), np.ones((5, 1))], 1)
    hp[2, 3] = 0.0  # a landmark at infinity is left out
    for est in (pj.est, pt.est):
        est.arch_lm = {10 + i: hp[i].copy() for i in range(5)}
    out = []
    for p, name in ((pj, "jax"), (pt, "port")):
        g2o = p.save_map(str(tmp_path / f"{name}.csv"))
        assert g2o == str(tmp_path / f"{name}.g2o")
        out.append((open(g2o).read(), open(tmp_path / f"{name}.csv").read()))
    assert out[0] == out[1]
    assert out[0][0].count("EDGE_SE3:QUAT") == N_KF - 1 and out[0][1].count("frame:") == N_KF


# ------------------------------------------------- relocalisation against JAX
def test_relocalisation_matches_jax(tmp_path, monkeypatch):
    """Both packages load the same component and relocalise the same session
    B keyframe, the port with the JAX package's draws: the bootstrapped
    vocabulary and the component's words are exact, `_geometric_verify`
    gives the same inliers and pose (1e-9), and after
    `_attempt_relocalisation` the estimators agree to 1e-9."""
    monkeypatch.setattr(bow, "init_indices", jax_init_indices)
    monkeypatch.setattr(ransac, "sample_indices", jax_sample_indices)
    frames = session_a()
    path = component_file(tmp_path, frames)
    pj, pt = jpipe(), tpipe(vocab_path=str(tmp_path / "missing.npz"))
    try:
        assert pt.vocab is None and not pt._vocab_pretrained
        pj.vocab = pj.bow_db = None
        assert pj.load_component(path) and pt.load_component(path)
        np.testing.assert_array_equal(pt.vocab.numpy(), convert.pack_pm1(pj.vocab))
        jrecs, trecs = pj.components[0]["records"], pt.components[0]["records"]
        assert sorted(jrecs) == sorted(trecs) == list(range(-N_KF, 0))
        for f in jrecs:
            np.testing.assert_array_equal(trecs[f]["words"], jrecs[f]["words"])

        _, rj = session_b(pj, frames, JFrameState)
        _, rt = session_b(pt, frames, FrameState, device=True)
        words = np.asarray(jbow.assign(jdesc.unpack_pm1(jnp.asarray(rj["packed"]),
                                                        jnp.asarray(rj["valid"])), pj.vocab))
        np.testing.assert_array_equal(
            bow.assign_packed(rt["packed_d"], rt["valid_d"], pt.vocab).numpy(), words)
        assert pt.components[0]["db"].query(words, rt["valid"], top=3) == \
            pj.components[0]["db"].query(words, rj["valid"], top=3)

        cand = pj.components[0]["db"].query(words, rj["valid"], top=3)[0][0]
        vj = pj._geometric_verify(0, rj, jrecs[cand])
        sites = []
        match = hamming.hamming_match
        monkeypatch.setattr(hamming, "hamming_match",
                            lambda *a, **kw: sites.append(kw.get("site")) or match(*a, **kw))
        vt = pt._geometric_verify(0, rt, trecs[cand])
        assert sites == ["reloc"]  # one camera, one match against the candidate
        assert vt[1] == vj[1] >= 15 and vt[2] == vj[2]
        np.testing.assert_allclose(vt[0], np.asarray(vj[0]), rtol=0, atol=1e-9)

        assert pj._attempt_relocalisation(0, words, rj)
        assert pt._attempt_relocalisation(0, words, rt)
        assert (pt.relocalised, pt.n_relocalisations) == (pj.relocalised, pj.n_relocalisations)
        ej, et = pj.est, pt.est
        assert sorted(et.archive_frames) == sorted(ej.archive_frames)
        for a, b in zip([et.get_state(0)] + [et.archive_frames[f] for f in range(-N_KF, 0)],
                        [ej.get_state(0)] + [ej.archive_frames[f] for f in range(-N_KF, 0)]):
            np.testing.assert_allclose(a.T_WS, b.T_WS, rtol=0, atol=1e-9)
            assert a.pose_fixed == b.pose_fixed
        assert [(e["i"], e["j"], bool(e.get("loop"))) for e in et.archive_edges] == \
            [(e["i"], e["j"], bool(e.get("loop"))) for e in ej.archive_edges]
        np.testing.assert_allclose(et.archive_edges[-1]["T_ij"], ej.archive_edges[-1]["T_ij"],
                                   rtol=0, atol=1e-9)
        assert et.correction_epoch == ej.correction_epoch

        # the JAX state with its loaded component carries over to the port
        est = SlidingWindowEstimator(convert.estimator_config(ej.cfg), pt.cameras, T_SC,
                                     device="cpu")
        convert.estimator_state(ej, est)
        assert sorted(est.archive_frames) == sorted(ej.archive_frames)
        assert all(est.archive_frames[f].pose_fixed for f in range(-N_KF, 0))
    finally:
        stop(pj, pt)
