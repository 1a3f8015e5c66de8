"""The port's own spans, off unless switched on.

Spans name the work where it happens: ``rt.prefill`` / ``rt.decode``
around the model's calls, ``rt.attn``, ``rt.mlp`` / ``rt.moe``,
``rt.mamba``, ``rt.mlstm`` / ``rt.slstm`` and ``rt.cross`` around each
block's sublayers (``rt.shared`` around a shared expert, inside
``rt.moe``; inside a latent attention's ``rt.attn``, ``rt.mla.latent``
around its down-projection, latent norm, k_pe rotation and cache write,
and ``rt.mla.expand`` in a prefill or ``rt.mla.absorb`` in a decode
step), ``rt.logits`` around the final norm and unembedding,
and ``rt.admit``, ``rt.readback`` and ``rt.sample`` in the serving
engine. While tracing is on, each is a ``record_function`` range: a
``torch.profiler`` running at the same time puts it in its trace, on the
clock of the device's events, nested as the calls nest. While it is off
(the default), :func:`span` hands back one shared null context, so a span
costs a call and a boolean test. The MoE dispatch counts its capacity
rows while tracing is on (:func:`repro_torch.models.moe.read_moe_stats`).
``repro_torch.serving.engine``'s docstring shows a profiled run.
"""
from __future__ import annotations

import contextlib
from typing import Optional

from torch.autograd.profiler import record_function

_NULL = contextlib.nullcontext()
_on = False


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str, args: Optional[str] = None):
    """A context that records ``name`` (with ``args``, e.g. a request's
    uid) as a profiler range while tracing is on, and does nothing while
    it is off."""
    if not _on:
        return _NULL
    return record_function(name, args)
