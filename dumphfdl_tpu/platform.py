"""Per-platform implementation choices, made in one place.

Everything that differs between the GPU and the CPU is decided here from
``jax.default_backend()``:

* the tracker symbol loop: the Pallas/Triton kernel on the GPU
  (dsp/tracker_pallas.py), the ``lax.scan`` version elsewhere;
* ``fused_event_decode``: frames decoded per block inside the separate
  on-device event-decode program (dsp/channel.py fused_collect), or 0 for
  the per-mode gather path.

The Viterbi decoder is plain ``lax`` on every platform (ops/fec.py).

Interpret mode is never chosen here: only a caller that asks for the
``'interpret'`` tracker (tests on the CPU) gets it.  ``DUMPHFDL_TRACKER``
(``scan`` or ``kernel``) overrides the tracker, to run the scan oracle on
the GPU.
"""

from __future__ import annotations

import dataclasses
import os

import jax

TRACKERS = ('scan', 'kernel', 'interpret')


@dataclasses.dataclass(frozen=True)
class Choice:
    tracker: str                # one of TRACKERS
    fused_event_decode: int     # frames per block decoded on device; 0 = gather path


def choose(backend: str) -> Choice:
    if backend == 'gpu':
        return Choice(tracker='kernel', fused_event_decode=64)
    return Choice(tracker='scan', fused_event_decode=0)


def current() -> Choice:
    choice = choose(jax.default_backend())
    override = os.environ.get('DUMPHFDL_TRACKER')
    if override:
        if override not in ('scan', 'kernel'):
            raise ValueError(f'DUMPHFDL_TRACKER={override!r}: '
                             "expected 'scan' or 'kernel'")
        choice = dataclasses.replace(choice, tracker=override)
    return choice
