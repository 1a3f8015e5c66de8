"""The paper's three evaluation workflows (§II-A Fig. 1, §IV-A c).

Calibration targets (paper Fig. 2 / §IV):

* **Chatbot** — scatter pattern; parallel classifier training; SLO
  120 s; decoupled uniform optimum ≈ (1 vCPU, 512 MB).
* **ML Pipeline** — broadcast pattern; dimensionality reduction +
  training + testing; CPU-heavy / memory-light; SLO 120 s; decoupled
  uniform optimum ≈ (4 vCPU, 512 MB) — 87.5 % less memory than the
  coupled point (4 vCPU ⇒ 4096 MB).
* **Video Analysis** — scatter pattern; split / extract / classify;
  CPU- *and* memory-heavy; SLO 600 s; decoupled uniform optimum ≈
  (8 vCPU, 5120 MB).

Response-surface constants are chosen so those optima emerge from the
cost model (see each builder's comments); tests assert the qualitative
affinities rather than the raw constants.

The port's copy of ``src/repro/serverless/workloads.py`` (lines 1-132),
numpy and plain Python as there, so that its float operations run in the
same order.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.core.dag import Workflow
from repro_torch.serverless.function import FunctionSpec


def _add(wf: Workflow, spec: FunctionSpec) -> None:
    wf.add_function(spec.name, payload=spec)


def chatbot() -> Workflow:
    """parse -> preprocess -> {train_clf_a, train_clf_b} -> upload ->
    intent_detect -> respond.  Balanced affinity: modest parallelism,
    small working sets; the 120 s SLO binds around 1 vCPU."""
    wf = Workflow("chatbot")
    _add(wf, FunctionSpec("parse_input", cpu_work=2.0, parallel_frac=0.3,
                          mem_floor=256, mem_knee=384, mem_penalty=2.0,
                          io_time=0.5))
    _add(wf, FunctionSpec("preprocess", cpu_work=12.0, parallel_frac=0.5,
                          mem_floor=320, mem_knee=512, mem_penalty=3.0,
                          io_time=0.5))
    _add(wf, FunctionSpec("train_clf_a", cpu_work=55.0, parallel_frac=0.8,
                          mem_floor=384, mem_knee=512, mem_penalty=4.0,
                          io_time=1.0))
    _add(wf, FunctionSpec("train_clf_b", cpu_work=30.0, parallel_frac=0.8,
                          mem_floor=384, mem_knee=512, mem_penalty=4.0,
                          io_time=1.0))
    _add(wf, FunctionSpec("upload_model", cpu_work=1.0, parallel_frac=0.1,
                          mem_floor=192, mem_knee=256, mem_penalty=1.0,
                          io_time=4.0))
    _add(wf, FunctionSpec("intent_detect", cpu_work=18.0, parallel_frac=0.6,
                          mem_floor=320, mem_knee=448, mem_penalty=2.5,
                          io_time=0.5))
    _add(wf, FunctionSpec("format_response", cpu_work=1.5, parallel_frac=0.3,
                          mem_floor=192, mem_knee=256, mem_penalty=1.0,
                          io_time=0.5))
    wf.chain("parse_input", "preprocess", "train_clf_a", "upload_model",
             "intent_detect", "format_response")
    wf.add_edge("preprocess", "train_clf_b")
    wf.add_edge("train_clf_b", "upload_model")
    return wf


def ml_pipeline() -> Workflow:
    """load -> pca -> {train_model, train_model_b} -> test.  CPU-heavy,
    memory-light (floors ≈ 350-450 MB): the decoupled optimum sits at
    high vCPU + 512 MB, which coupled schemes cannot express."""
    wf = Workflow("ml_pipeline")
    _add(wf, FunctionSpec("load_data", cpu_work=4.0, parallel_frac=0.3,
                          mem_floor=320, mem_knee=448, mem_penalty=2.0,
                          io_time=2.0))
    _add(wf, FunctionSpec("pca", cpu_work=90.0, parallel_frac=0.85,
                          mem_floor=384, mem_knee=512, mem_penalty=3.0,
                          io_time=1.0))
    _add(wf, FunctionSpec("train_model", cpu_work=160.0, parallel_frac=0.9,
                          mem_floor=448, mem_knee=512, mem_penalty=3.0,
                          io_time=1.0))
    _add(wf, FunctionSpec("train_model_b", cpu_work=100.0, parallel_frac=0.9,
                          mem_floor=448, mem_knee=512, mem_penalty=3.0,
                          io_time=1.0))
    _add(wf, FunctionSpec("test_model", cpu_work=30.0, parallel_frac=0.7,
                          mem_floor=384, mem_knee=512, mem_penalty=3.0,
                          io_time=1.0))
    wf.chain("load_data", "pca", "train_model", "test_model")
    wf.add_edge("pca", "train_model_b")
    wf.add_edge("train_model_b", "test_model")
    return wf


def video_analysis() -> Workflow:
    """split -> {extract_a, extract_b, extract_c} -> classify -> aggregate.
    CPU- and memory-heavy (multi-GB working sets, real paging penalty);
    the 600 s SLO binds around 8 vCPU and memory binds at ≈5 GB."""
    wf = Workflow("video_analysis")
    _add(wf, FunctionSpec("split_video", cpu_work=90.0, parallel_frac=0.6,
                          mem_floor=4096, mem_knee=5120, mem_penalty=5.0,
                          io_time=5.0))
    _add(wf, FunctionSpec("extract_a", cpu_work=700.0, parallel_frac=0.92,
                          mem_floor=3072, mem_knee=4608, mem_penalty=4.0,
                          io_time=2.0))
    _add(wf, FunctionSpec("extract_b", cpu_work=520.0, parallel_frac=0.92,
                          mem_floor=3072, mem_knee=4608, mem_penalty=4.0,
                          io_time=2.0))
    _add(wf, FunctionSpec("extract_c", cpu_work=390.0, parallel_frac=0.92,
                          mem_floor=3072, mem_knee=4608, mem_penalty=4.0,
                          io_time=2.0))
    _add(wf, FunctionSpec("classify_frames", cpu_work=620.0, parallel_frac=0.85,
                          mem_floor=4608, mem_knee=5120, mem_penalty=4.0,
                          io_time=2.0))
    _add(wf, FunctionSpec("aggregate", cpu_work=15.0, parallel_frac=0.4,
                          mem_floor=512, mem_knee=1024, mem_penalty=1.5,
                          io_time=3.0))
    for ext in ("extract_a", "extract_b", "extract_c"):
        wf.add_edge("split_video", ext)
        wf.add_edge(ext, "classify_frames")
    wf.add_edge("classify_frames", "aggregate")
    return wf


#: §IV-A(c): SLOs of 120 s, 120 s and 600 s.
_SLOS: Dict[str, float] = {"chatbot": 120.0, "ml_pipeline": 120.0,
                           "video_analysis": 600.0}

WORKLOADS: Dict[str, Callable[[], Workflow]] = {
    "chatbot": chatbot,
    "ml_pipeline": ml_pipeline,
    "video_analysis": video_analysis,
}


def workload_slo(name: str) -> float:
    return _SLOS[name]
