"""Writes the GMM pickles the PyTorch port's tests and `chip_smoke.py`
read, with sklearn itself (the fixture was written by sklearn 1.9.0 under
numpy 2.0.2, so its arrays name `numpy._core`):

- `full.pkl`, `diag.pkl`: `pickle.dump` of a `GaussianMixture(
  n_components=4, covariance_type=...)` fitted (20 EM steps, reg_covar
  1e-4, random_state 0) on 400 flattened 10-frame windows of one joint
  coordinate set (D = 45: 15 joints x 3 of the frame mean) of
  `data/synthetic.py::synthetic_motion(4000, 0)` plus N(0, 0.01) noise
  (numpy seed 0), in float32, so that sklearn keeps float32
  parameters and both pickles stay near 100 KB;
- `full_randomstate.pkl`: the 'full' fit with `random_state=
  np.random.RandomState(0)` in place of the integer seed, so the pickle
  also holds numpy's random state (its MT19937 state after the fit).

    python tests/torch_fixtures/gmm_sklearn/make_fixture.py

rewrites the pickles beside this script.
"""

import os
import pickle
import sys
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

K, D, N = 4, 45, 400


def windows():
    """(N, D) float32 rows: each 10-frame window's mean pose, noised."""
    import numpy as np
    from globalegomocap_tpu_torch.data.synthetic import synthetic_motion
    motion = synthetic_motion(N * 10, 0, motion_scale=0.08)
    x = motion.reshape(N, 10, D).mean(1).astype(np.float64)
    x = x + np.random.default_rng(0).normal(scale=0.01, size=x.shape)
    return x.astype(np.float32)


def main():
    from sklearn.mixture import GaussianMixture
    x = windows()
    import numpy as np
    for name, kind, seed in (("full", "full", 0), ("diag", "diag", 0),
                             ("full_randomstate", "full",
                              np.random.RandomState(0))):
        gm = GaussianMixture(n_components=K, covariance_type=kind,
                             max_iter=20, reg_covar=1e-4, random_state=seed)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            gm.fit(x)
        with open(os.path.join(HERE, f"{name}.pkl"), "wb") as f:
            pickle.dump(gm, f)


if __name__ == "__main__":
    main()
