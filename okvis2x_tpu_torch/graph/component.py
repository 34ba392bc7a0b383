"""Multi-session map save/load (torch counterpart of
``okvis2x_tpu/graph/component.py``, plain numpy; the files are the same in
both packages).

A saved session holds keyframe poses, pose-graph edges, landmarks, and per
keyframe the binary descriptors, keypoints and landmark snapshot, enough for
a later session to relocalise against it (reference:
Frontend::loadComponent builds a DBoW database from the loaded frames,
okvis_frontend/src/Frontend.cpp:163-201).

Format: a single versioned .npz, no native dependencies.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

FORMAT_VERSION = 1


def save_component(path: str, est, kf_records: Optional[Dict[int, dict]] = None):
    """Serialise the estimator's long-term state (+ optional pipeline
    keyframe records with descriptors)."""
    nodes, edges = est.pose_graph()
    data = dict(
        version=np.int64(FORMAT_VERSION),
        frame_fids=np.array([f.fid for f in nodes], np.int64),
        frame_ts=np.array([f.timestamp for f in nodes]),
        frame_T_WS=np.stack([f.T_WS for f in nodes]) if nodes else np.zeros((0, 7)),
        edge_i=np.array([e["i"] for e in edges], np.int64),
        edge_j=np.array([e["j"] for e in edges], np.int64),
        edge_T=np.stack([e["T_ij"] for e in edges]) if edges else np.zeros((0, 7)),
        edge_sqrt_info=(
            np.stack([e["sqrt_info"] for e in edges]) if edges else np.zeros((0, 6, 6))
        ),
        lm_ids=np.array(
            list(est.lm_index.keys()) + list(est.arch_lm.keys()), np.int64
        ),
        lm_hp=np.vstack(
            [est.hp_W] + [h[None] for h in est.arch_lm.values()]
        ) if (len(est.lm_ids) or est.arch_lm) else np.zeros((0, 4)),
        T_SC=est.T_SC,
    )
    if kf_records:
        fids = sorted(kf_records.keys())
        data["rec_fids"] = np.array(fids, np.int64)
        # uint32 words, as the JAX package keeps them (the port's are int32)
        data["rec_packed"] = np.ascontiguousarray(
            np.stack([kf_records[f]["packed"] for f in fids])).view(np.uint32)
        data["rec_valid"] = np.stack([kf_records[f]["valid"] for f in fids])
        data["rec_uv"] = np.stack([kf_records[f]["uv"] for f in fids])
        data["rec_lm_pos"] = np.stack([kf_records[f]["lm_pos"] for f in fids])
    np.savez_compressed(path, **data)


def load_component(path: str) -> dict:
    """Load a saved session into plain dict form (frames, edges, landmarks,
    descriptor records) for relocalisation / map merging."""
    z = np.load(path, allow_pickle=False)
    assert int(z["version"]) <= FORMAT_VERSION
    out = dict(
        frame_fids=z["frame_fids"],
        frame_ts=z["frame_ts"],
        frame_T_WS=z["frame_T_WS"],
        edges=[
            dict(i=int(i), j=int(j), T_ij=T, sqrt_info=S)
            for i, j, T, S in zip(
                z["edge_i"], z["edge_j"], z["edge_T"], z["edge_sqrt_info"]
            )
        ],
        lm_ids=z["lm_ids"],
        lm_hp=z["lm_hp"],
        T_SC=z["T_SC"],
    )
    if "rec_fids" in z:
        out["records"] = {
            int(f): dict(
                packed=z["rec_packed"][i],
                valid=z["rec_valid"][i],
                uv=z["rec_uv"][i],
                lm_pos=z["rec_lm_pos"][i],
            )
            for i, f in enumerate(z["rec_fids"])
        }
    return out


def save_map(path: str, est, kf_records: Optional[Dict[int, dict]] = None):
    """Export the long-term map in the reference's saveMap layout
    (≙ ViSlamBackend::saveMap, okvis_ceres/src/ViSlamBackend.cpp:2166):
    a `.g2o` pose graph (standard VERTEX_SE3:QUAT / EDGE_SE3:QUAT) next to
    a text map file listing landmarks, per-frame covisibilities and
    observations (keypoint id, landmark id, position, descriptor hex)."""
    nodes, edges = est.pose_graph()

    g2o_path = (path[:-4] if path.endswith(".csv") else path) + ".g2o"
    with open(g2o_path, "w") as f:
        for n in nodes:
            t, q = n.T_WS[:3], n.T_WS[3:7]
            f.write(
                f"VERTEX_SE3:QUAT {n.fid} "
                f"{t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n"
            )
        for e in edges:
            t, q = e["T_ij"][:3], e["T_ij"][3:7]
            info = e["sqrt_info"].T @ e["sqrt_info"]
            upper = " ".join(
                str(info[i, j]) for i in range(6) for j in range(i, 6)
            )
            f.write(
                f"EDGE_SE3:QUAT {e['i']} {e['j']} "
                f"{t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]} {upper}\n"
            )

    with open(path, "w") as f:
        f.write("landmarks:\n")
        lm_pos = {}
        for lid, row in est.lm_index.items():
            hp = est.hp_W[row]
            if abs(hp[3]) > 1e-9:
                lm_pos[lid] = hp[:3] / hp[3]
        for lid, hp in est.arch_lm.items():
            if lid not in lm_pos and abs(hp[3]) > 1e-9:
                lm_pos[lid] = hp[:3] / hp[3]
        for lid in sorted(lm_pos):
            p3 = lm_pos[lid]
            f.write(f"{lid},{p3[0]},{p3[1]},{p3[2]}\n")
        covis = {}
        for e in edges:
            covis.setdefault(e["i"], set()).add(e["j"])
            covis.setdefault(e["j"], set()).add(e["i"])
        for n in nodes:
            ids = " ".join(str(c) for c in sorted(covis.get(n.fid, ())))
            f.write(f"frame: {n.fid}, covisibilities: {ids}\n")
            rec = (kf_records or {}).get(n.fid)
            if rec is None:
                continue
            lmp = rec.get("lm_pos")
            packed = rec.get("packed")
            if lmp is None or packed is None:
                continue
            for k in range(len(lmp)):
                if not np.isfinite(lmp[k, 0]):
                    continue
                desc = packed[k].astype("<u4").tobytes().hex()
                f.write(
                    f"{k},-1,{lmp[k,0]},{lmp[k,1]},{lmp[k,2]},{desc}\n"
                )
    return g2o_path
