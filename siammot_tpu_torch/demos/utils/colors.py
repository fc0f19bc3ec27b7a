"""The demo's track colours without matplotlib: ``get_n_colors`` of
``demos/utils/vis_generator.py`` (matplotlib's ``gist_ncar`` sampled at n
points, shuffled by ``RandomState(seed)``).

The colormap is kept here as its segment data (matplotlib's
``_cm._gist_ncar_data``) and turned into matplotlib's 256-entry lookup
table by the same interpolation (``colors._create_lookup_table``); a value
x in [0, 1] takes entry ``int(x * 256)`` (the last for x = 1).
"""

from __future__ import annotations

import numpy as np

N_LUT = 256
GIST_NCAR = {
    "red": ((0.0, 0.0, 0.0), (0.3098, 0.0, 0.0), (0.3725, 0.3993, 0.3993),
            (0.4235, 0.5003, 0.5003), (0.5333, 1.0, 1.0),
            (0.7922, 1.0, 1.0), (0.8471, 0.6218, 0.6218),
            (0.898, 0.9235, 0.9235), (1.0, 0.9961, 0.9961)),
    "green": ((0.0, 0.0, 0.0), (0.051, 0.3722, 0.3722), (0.1059, 0.0, 0.0),
              (0.1569, 0.7202, 0.7202), (0.1608, 0.7537, 0.7537),
              (0.1647, 0.7752, 0.7752), (0.2157, 1.0, 1.0),
              (0.2588, 0.9804, 0.9804), (0.2706, 0.9804, 0.9804),
              (0.3176, 1.0, 1.0), (0.3686, 0.8081, 0.8081),
              (0.4275, 1.0, 1.0), (0.5216, 1.0, 1.0),
              (0.6314, 0.7292, 0.7292), (0.6863, 0.2796, 0.2796),
              (0.7451, 0.0, 0.0), (0.7922, 0.0, 0.0),
              (0.8431, 0.1753, 0.1753), (0.898, 0.5, 0.5),
              (1.0, 0.9725, 0.9725)),
    "blue": ((0.0, 0.502, 0.502), (0.051, 0.0222, 0.0222),
             (0.1098, 1.0, 1.0), (0.2039, 1.0, 1.0),
             (0.2627, 0.6145, 0.6145), (0.3216, 0.0, 0.0),
             (0.4157, 0.0, 0.0), (0.4745, 0.2342, 0.2342),
             (0.5333, 0.0, 0.0), (0.5804, 0.0, 0.0),
             (0.6314, 0.0549, 0.0549), (0.6902, 0.0, 0.0),
             (0.7373, 0.0, 0.0), (0.7922, 0.9738, 0.9738),
             (0.8, 1.0, 1.0), (0.8431, 1.0, 1.0), (0.898, 0.9341, 0.9341),
             (1.0, 0.9961, 0.9961)),
}


def lookup_table(data, n: int = N_LUT) -> np.ndarray:
    """matplotlib's linear-segment lookup table of one channel."""
    adata = np.array(data)
    x, y0, y1 = adata[:, 0] * (n - 1), adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1])
                          + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def get_n_colors(n: int, seed: int = 0) -> np.ndarray:
    """[n, 3] float64 RGB in [0, 255]: the JAX demo's ``get_n_colors(n)``
    (which returns BGR) with its channels reversed."""
    lut = np.stack([lookup_table(GIST_NCAR[c]) for c in
                    ("red", "green", "blue")], axis=1)
    xa = np.linspace(0, 1, n) * N_LUT
    xa[xa == N_LUT] = N_LUT - 1
    colors = lut[xa.astype(int)]
    np.random.RandomState(seed).shuffle(colors)
    return colors * 255
