"""Carry state between the JAX package and the port, through numpy.

Inputs are the JAX package's NamedTuples, dataclasses and configs with numpy
leaves (callers ``np.asarray`` each field first); nothing here imports JAX.
Floating fields become tensors of the requested dtype on the requested
device, integer index fields int64, masks bool.  `to_numpy` turns the
port's results back into numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from okvis2x_tpu_torch.cameras.pinhole import Camera
from okvis2x_tpu_torch.graph.estimator import EstimatorConfig
from okvis2x_tpu_torch.imu.preintegration import ImuParams, Preintegrated
from okvis2x_tpu_torch.pipeline.vio import PipelineConfig
from okvis2x_tpu_torch.solver.gauss_newton import StackedCameras
from okvis2x_tpu_torch.solver.problem import BAProblem

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype for a numpy/JAX dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[np.dtype(dtype).name]


def tensor(x, dtype=torch.float64, device=None) -> torch.Tensor:
    """numpy -> tensor: floating arrays take `dtype`, integer arrays int64,
    booleans stay bool."""
    a = np.asarray(x)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def camera(cam, dtype=torch.float64, device=None) -> Camera:
    return Camera(
        fxfycxcy=tensor(cam.fxfycxcy, dtype, device),
        dist_params=tensor(cam.dist_params, dtype, device),
        width=int(cam.width), height=int(cam.height), model=cam.model,
    )


def stacked_cameras(cams, dtype=torch.float64, device=None) -> StackedCameras:
    return StackedCameras(
        fxfycxcy=tensor(cams.fxfycxcy, dtype, device),
        dist_params=tensor(cams.dist_params, dtype, device),
        width=int(cams.width), height=int(cams.height), model=cams.model,
    )


def imu_params(params) -> ImuParams:
    return ImuParams(**{k: float(getattr(params, k)) for k in ImuParams._fields})


def preintegrated(pre, dtype=torch.float64, device=None) -> Preintegrated:
    return Preintegrated(*[tensor(getattr(pre, k), dtype, device)
                           for k in Preintegrated._fields])


def ba_problem(p, dtype=torch.float64, device=None) -> BAProblem:
    """JAX `BAProblem` (numpy leaves) -> port `BAProblem`.  Submap-ICP rows
    are not ported and must be absent."""
    icp_a = getattr(p, "icp_a", None)
    if icp_a is not None and np.asarray(icp_a).shape[0]:
        raise NotImplementedError("submap ICP rows are not ported yet")
    out = {}
    for k in BAProblem._fields:
        v = getattr(p, k)
        if k in ("imu_pre", "gps_pre"):
            out[k] = preintegrated(v, dtype, device)
        else:
            out[k] = tensor(v, dtype, device)
    return BAProblem(**out)


def estimator_config(cfg) -> EstimatorConfig:
    """JAX `EstimatorConfig` -> port `EstimatorConfig` (same field names)."""
    kw = {}
    for f in dataclasses.fields(EstimatorConfig):
        v = getattr(cfg, f.name)
        if f.name == "imu":
            v = imu_params(v)
        elif f.name == "dtype":
            v = torch_dtype(v)
        kw[f.name] = v
    return EstimatorConfig(**kw)


def pipeline_config(cfg) -> PipelineConfig:
    """JAX `PipelineConfig` -> port `PipelineConfig` (the fields the port
    has; the unported features keep their values, so enabling them raises
    when the pipeline is built)."""
    return PipelineConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(PipelineConfig)})


def to_numpy(x):
    """Tensors -> numpy arrays, recursively through tuples, NamedTuples,
    lists, dicts and the port's dataclasses."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[to_numpy(v) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: to_numpy(getattr(x, f.name)) for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)
        })
    return x
