"""Which of a run's results are judged, and by what.

Once the window has closed and the program's state is freed, :func:`sample`
draws from the seed a sample of the requests the window finished, with the
longest among them. The architecture of the cell's configuration
(``benchmark/architectures/<architecture>.py``) judges them with its
``judge``: it runs its plain float32 reference over each request's prompt
and served tokens, and returns the numbers compared. Each number has its
limit in the cell's traffic file (``limits``), set from readings of the
program and of a control in lower precision; ``benchmark/run.py`` holds
the readings to the limits, and the run is correct when no number passes
its limit.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .records import Req, Run

SAMPLE = 16     # requests judged a run
LONGEST = 2     # of them, those with the most served tokens


def sample(run: Run, seed: int) -> List[Req]:
    """``LONGEST`` of the window's finished requests with the most served
    tokens, then others drawn from the seed, ``SAMPLE`` in all."""
    size, longest = SAMPLE, LONGEST
    done = [r for r in run.counted() if r.ok]
    done.sort(key=lambda r: (-r.output._n_gen, r.due))
    picked, rest = done[:longest], done[longest:]
    rng = np.random.default_rng([int(seed), 2])
    extra = rng.choice(len(rest), size=min(size - len(picked), len(rest)), replace=False)
    return picked + [rest[i] for i in sorted(extra)]

