"""The one generator behind every traffic mix.

A mix is a data file, `egobench/traffic/<name>.json`, whose `kind` names
the loop that drives it and whose other keys are its parameters:

- kind "solve_closed_loop" (egobench/loops/solve_closed_loop.py): a
  pool of synthetic chunks rendered once a run on `render_threads` host
  threads (`pool`: groups of {"count", "chunk": keyword arguments of
  `synthetic.synthetic_chunk`}), and requests of `chunks_per_request`
  chunks of `frames_per_chunk` frames drawn from the pool, each in a
  new order drawn from the seed, sent in a closed loop;
- kind "train_steps" (egobench/loops/train_steps.py): a corpus of
  relative-global training windows (`corpus`: keyword arguments of
  `synthetic.training_windows`) fed in batches of `batch` windows,
  shuffled each epoch.

Every key a loop reads is required: a mix states all of its
parameters.

Everything is drawn from the run's seed: the same seed gives the same
inputs, another seed the same amount of work on other data.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from egobench.harness import synthetic


def chunk_seed(seed: int, index: int) -> int:
    """The generator seed of pool chunk `index` of a run."""
    return int(np.random.SeedSequence([int(seed), 1, index])
               .generate_state(1, np.uint32)[0])


def pool_specs(mix: dict) -> list:
    """Chunk keyword arguments of each pool entry, in pool order."""
    out = []
    for group in mix["pool"]:
        out.extend([dict(group["chunk"])] * int(group["count"]))
    return out


def solve_pool(mix: dict, camera: dict, seed: int) -> list:
    """The run's pool of chunks (dicts of numpy arrays), rendered on
    `mix["render_threads"]` host threads."""
    specs = pool_specs(mix)
    frames = int(mix["frames_per_chunk"])

    def make(i):
        return synthetic.synthetic_chunk(camera, n_frames=frames,
                                         seed=chunk_seed(seed, i),
                                         **specs[i])

    with ThreadPoolExecutor(int(mix["render_threads"])) as ex:
        return list(ex.map(make, range(len(specs))))


def request_order(mix: dict, seed: int, rid: int) -> np.ndarray:
    """Pool indices of request `rid`'s chunks, in their order."""
    rng = np.random.default_rng([int(seed), 2, int(rid)])
    n = len(pool_specs(mix))
    return rng.permutation(n)[:int(mix["chunks_per_request"])]


def training_corpus(mix: dict, seed: int) -> np.ndarray:
    """The run's training windows (W, T, 45) float32."""
    c = mix["corpus"]
    return synthetic.training_windows(
        int(c["sequences"]), int(c["frames_per_seq"]),
        chunk_seed(seed, 0), motion_scale=float(c["motion_scale"]),
        freq_range=tuple(c["freq_range"]))
