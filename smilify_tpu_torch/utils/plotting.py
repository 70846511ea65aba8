"""A small figure renderer on numpy and OpenCV, in place of matplotlib.

The card's machine has OpenCV but no matplotlib, and the port's entry points
write the plots that the JAX package writes through pyplot: the trainers'
history curves, the benchmark's PCK curve and error histogram, the
registration's loss curves, the 3D keypoint, mesh, point-cloud and heatmap
plots, and the PCA component scatters. This module draws them with the
subset of pyplot's API that those sites call (:func:`subplots`,
:func:`figure`, ``Axes.plot/semilogy/scatter/hist/axhline`` and the 3D axes'
``scatter/plot/plot_trisurf``), so that each site reads as its JAX
counterpart does:

  * a file is an RGBA PNG of matplotlib's pixel size, ``int(figsize ×
    dpi)`` (the figure's dpi is 100, ``savefig(dpi=)`` overrides it);
  * 2D limits are matplotlib's autoscale (``axes.xmargin``/``ymargin`` 0.05,
    log margins taken in log space from the smallest positive value, the
    histogram bars' sticky 0, the locators' ``nonsingular`` expansion, shared
    x axes, ``axhline``'s rescale only when its line falls outside the
    limits of the moment);
  * 3D axes are mplot3d's projection for ``view_init(elev, azim)``
    with the default box aspect (4:4:3) and perspective (focal length 1,
    camera distance 10), autoscaled as mplot3d does (margin 0.05, then the
    view margin of 1/48) unless the limits are set;
  * lines and markers take matplotlib's default colour cycle (``tab10``),
    faces are drawn back to front with ``cv2.fillPoly``, shaded as
    ``plot_trisurf``'s default ``shade=True`` (mplot3d's light source at
    azimuth 225°, altitude 19.4712°), ``plot_mesh_heatmap``'s colormap is a
    256-entry copy of matplotlib's viridis (:data:`VIRIDIS`).

Fonts, antialiasing and the layout are OpenCV's and this module's: the
pictures are not matplotlib's pixels. Data lines and markers are drawn
without antialiasing, so each series' colour is exact along its line.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["TAB10", "VIRIDIS", "Axes", "Axes3D", "Figure", "colormap", "figure", "subplots",
           "to_rgb"]

# matplotlib's default property cycle (rcParams["axes.prop_cycle"], tab10)
TAB10 = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd", "#8c564b", "#e377c2",
         "#7f7f7f", "#bcbd22", "#17becf")
# the CSS colours the plot sites name
_NAMED = {"black": "#000000", "red": "#ff0000", "green": "#008000", "gray": "#808080",
          "grey": "#808080", "lightblue": "#add8e6"}

# matplotlib's viridis (matplotlib/_cm_listed.py::_viridis_data): 256 RGB entries
VIRIDIS = np.array((
    "0.267004 0.004874 0.329415 0.26851 0.009605 0.335427 0.269944 0.014625 0.341379 0.271305 0.019942 "
    "0.347269 0.272594 0.025563 0.353093 0.273809 0.031497 0.358853 0.274952 0.037752 0.364543 0.276022 "
    "0.044167 0.370164 0.277018 0.050344 0.375715 0.277941 0.056324 0.381191 0.278791 0.062145 0.386592 "
    "0.279566 0.067836 0.391917 0.280267 0.073417 0.397163 0.280894 0.078907 0.402329 0.281446 0.08432 "
    "0.407414 0.281924 0.089666 0.412415 0.282327 0.094955 0.417331 0.282656 0.100196 0.42216 0.28291 "
    "0.105393 0.426902 0.283091 0.110553 0.431554 0.283197 0.11568 0.436115 0.283229 0.120777 0.440584 "
    "0.283187 0.125848 0.44496 0.283072 0.130895 0.449241 0.282884 0.13592 0.453427 0.282623 0.140926 "
    "0.457517 0.28229 0.145912 0.46151 0.281887 0.150881 0.465405 0.281412 0.155834 0.469201 0.280868 "
    "0.160771 0.472899 0.280255 0.165693 0.476498 0.279574 0.170599 0.479997 0.278826 0.17549 0.483397 "
    "0.278012 0.180367 0.486697 0.277134 0.185228 0.489898 0.276194 0.190074 0.493001 0.275191 0.194905 "
    "0.496005 0.274128 0.199721 0.498911 0.273006 0.20452 0.501721 0.271828 0.209303 0.504434 0.270595 "
    "0.214069 0.507052 0.269308 0.218818 0.509577 0.267968 0.223549 0.512008 0.26658 0.228262 0.514349 "
    "0.265145 0.232956 0.516599 0.263663 0.237631 0.518762 0.262138 0.242286 0.520837 0.260571 0.246922 "
    "0.522828 0.258965 0.251537 0.524736 0.257322 0.25613 0.526563 0.255645 0.260703 0.528312 0.253935 "
    "0.265254 0.529983 0.252194 0.269783 0.531579 0.250425 0.27429 0.533103 0.248629 0.278775 0.534556 "
    "0.246811 0.283237 0.535941 0.244972 0.287675 0.53726 0.243113 0.292092 0.538516 0.241237 0.296485 "
    "0.539709 0.239346 0.300855 0.540844 0.237441 0.305202 0.541921 0.235526 0.309527 0.542944 0.233603 "
    "0.313828 0.543914 0.231674 0.318106 0.544834 0.229739 0.322361 0.545706 0.227802 0.326594 0.546532 "
    "0.225863 0.330805 0.547314 0.223925 0.334994 0.548053 0.221989 0.339161 0.548752 0.220057 0.343307 "
    "0.549413 0.21813 0.347432 0.550038 0.21621 0.351535 0.550627 0.214298 0.355619 0.551184 0.212395 "
    "0.359683 0.55171 0.210503 0.363727 0.552206 0.208623 0.367752 0.552675 0.206756 0.371758 0.553117 "
    "0.204903 0.375746 0.553533 0.203063 0.379716 0.553925 0.201239 0.38367 0.554294 0.19943 0.387607 "
    "0.554642 0.197636 0.391528 0.554969 0.19586 0.395433 0.555276 0.1941 0.399323 0.555565 0.192357 "
    "0.403199 0.555836 0.190631 0.407061 0.556089 0.188923 0.41091 0.556326 0.187231 0.414746 0.556547 "
    "0.185556 0.41857 0.556753 0.183898 0.422383 0.556944 0.182256 0.426184 0.55712 0.180629 0.429975 "
    "0.557282 0.179019 0.433756 0.55743 0.177423 0.437527 0.557565 0.175841 0.44129 0.557685 0.174274 "
    "0.445044 0.557792 0.172719 0.448791 0.557885 0.171176 0.45253 0.557965 0.169646 0.456262 0.55803 "
    "0.168126 0.459988 0.558082 0.166617 0.463708 0.558119 0.165117 0.467423 0.558141 0.163625 0.471133 "
    "0.558148 0.162142 0.474838 0.55814 0.160665 0.47854 0.558115 0.159194 0.482237 0.558073 0.157729 "
    "0.485932 0.558013 0.15627 0.489624 0.557936 0.154815 0.493313 0.55784 0.153364 0.497 0.557724 "
    "0.151918 0.500685 0.557587 0.150476 0.504369 0.55743 0.149039 0.508051 0.55725 0.147607 0.511733 "
    "0.557049 0.14618 0.515413 0.556823 0.144759 0.519093 0.556572 0.143343 0.522773 0.556295 0.141935 "
    "0.526453 0.555991 0.140536 0.530132 0.555659 0.139147 0.533812 0.555298 0.13777 0.537492 0.554906 "
    "0.136408 0.541173 0.554483 0.135066 0.544853 0.554029 0.133743 0.548535 0.553541 0.132444 0.552216 "
    "0.553018 0.131172 0.555899 0.552459 0.129933 0.559582 0.551864 0.128729 0.563265 0.551229 0.127568 "
    "0.566949 0.550556 0.126453 0.570633 0.549841 0.125394 0.574318 0.549086 0.124395 0.578002 0.548287 "
    "0.123463 0.581687 0.547445 0.122606 0.585371 0.546557 0.121831 0.589055 0.545623 0.121148 0.592739 "
    "0.544641 0.120565 0.596422 0.543611 0.120092 0.600104 0.54253 0.119738 0.603785 0.5414 0.119512 "
    "0.607464 0.540218 0.119423 0.611141 0.538982 0.119483 0.614817 0.537692 0.119699 0.61849 0.536347 "
    "0.120081 0.622161 0.534946 0.120638 0.625828 0.533488 0.12138 0.629492 0.531973 0.122312 0.633153 "
    "0.530398 0.123444 0.636809 0.528763 0.12478 0.640461 0.527068 0.126326 0.644107 0.525311 0.128087 "
    "0.647749 0.523491 0.130067 0.651384 0.521608 0.132268 0.655014 0.519661 0.134692 0.658636 0.517649 "
    "0.137339 0.662252 0.515571 0.14021 0.665859 0.513427 0.143303 0.669459 0.511215 0.146616 0.67305 "
    "0.508936 0.150148 0.676631 0.506589 0.153894 0.680203 0.504172 0.157851 0.683765 0.501686 0.162016 "
    "0.687316 0.499129 0.166383 0.690856 0.496502 0.170948 0.694384 0.493803 0.175707 0.6979 0.491033 "
    "0.180653 0.701402 0.488189 0.185783 0.704891 0.485273 0.19109 0.708366 0.482284 0.196571 0.711827 "
    "0.479221 0.202219 0.715272 0.476084 0.20803 0.718701 0.472873 0.214 0.722114 0.469588 0.220124 "
    "0.725509 0.466226 0.226397 0.728888 0.462789 0.232815 0.732247 0.459277 0.239374 0.735588 0.455688 "
    "0.24607 0.73891 0.452024 0.252899 0.742211 0.448284 0.259857 0.745492 0.444467 0.266941 0.748751 "
    "0.440573 0.274149 0.751988 0.436601 0.281477 0.755203 0.432552 0.288921 0.758394 0.428426 0.296479 "
    "0.761561 0.424223 0.304148 0.764704 0.419943 0.311925 0.767822 0.415586 0.319809 0.770914 0.411152 "
    "0.327796 0.77398 0.40664 0.335885 0.777018 0.402049 0.344074 0.780029 0.397381 0.35236 0.783011 "
    "0.392636 0.360741 0.785964 0.387814 0.369214 0.788888 0.382914 0.377779 0.791781 0.377939 0.386433 "
    "0.794644 0.372886 0.395174 0.797475 0.367757 0.404001 0.800275 0.362552 0.412913 0.803041 0.357269 "
    "0.421908 0.805774 0.35191 0.430983 0.808473 0.346476 0.440137 0.811138 0.340967 0.449368 0.813768 "
    "0.335384 0.458674 0.816363 0.329727 0.468053 0.818921 0.323998 0.477504 0.821444 0.318195 0.487026 "
    "0.823929 0.312321 0.496615 0.826376 0.306377 0.506271 0.828786 0.300362 0.515992 0.831158 0.294279 "
    "0.525776 0.833491 0.288127 0.535621 0.835785 0.281908 0.545524 0.838039 0.275626 0.555484 0.840254 "
    "0.269281 0.565498 0.84243 0.262877 0.575563 0.844566 0.256415 0.585678 0.846661 0.249897 0.595839 "
    "0.848717 0.243329 0.606045 0.850733 0.236712 0.616293 0.852709 0.230052 0.626579 0.854645 0.223353 "
    "0.636902 0.856542 0.21662 0.647257 0.8584 0.209861 0.657642 0.860219 0.203082 0.668054 0.861999 "
    "0.196293 0.678489 0.863742 0.189503 0.688944 0.865448 0.182725 0.699415 0.867117 0.175971 0.709898 "
    "0.868751 0.169257 0.720391 0.87035 0.162603 0.730889 0.871916 0.156029 0.741388 0.873449 0.149561 "
    "0.751884 0.874951 0.143228 0.762373 0.876424 0.137064 0.772852 0.877868 0.131109 0.783315 0.879285 "
    "0.125405 0.79376 0.880678 0.120005 0.804182 0.882046 0.114965 0.814576 0.883393 0.110347 0.82494 "
    "0.88472 0.106217 0.83527 0.886029 0.102646 0.845561 0.887322 0.099702 0.85581 0.888601 0.097452 "
    "0.866013 0.889868 0.095953 0.876168 0.891125 0.09525 0.886271 0.892374 0.095374 0.89632 0.893616 "
    "0.096335 0.906311 0.894855 0.098125 0.916242 0.896091 0.100717 0.926106 0.89733 0.104071 0.935904 "
    "0.89857 0.108131 0.945636 0.899815 0.112838 0.9553 0.901065 0.118128 0.964894 0.902323 0.123941 "
    "0.974417 0.90359 0.130215 0.983868 0.904867 0.136897 0.993248 0.906157 0.143936"
).split(), dtype=np.float64).reshape(256, 3)

_DPI = 100.0                  # rcParams["figure.dpi"]
_FIGSIZE = (6.4, 4.8)         # rcParams["figure.figsize"]
_MARGIN = 0.05                # rcParams["axes.xmargin"], ["axes.ymargin"], ["axes.zmargin"]
_FONT_PT = 10.0               # rcParams["font.size"]
_TITLE_PT = 12.0              # "large"
_LINE_PT = 1.5                # rcParams["lines.linewidth"]
_MARKER_PT2 = 36.0            # rcParams["lines.markersize"] ** 2, scatter's default s
_GRID_RGB = (0.69, 0.69, 0.69)


def to_rgb(color) -> Tuple[float, float, float]:
    """A colour as (r, g, b) in [0, 1]: ``#rrggbb``, a name of :data:`_NAMED`
    or a tuple of 3 or 4 floats."""
    if isinstance(color, str):
        color = _NAMED.get(color.lower(), color)
        if not (color.startswith("#") and len(color) == 7):
            raise ValueError(f"plotting: unknown colour {color!r}")
        return tuple(int(color[i:i + 2], 16) / 255.0 for i in (1, 3, 5))
    return tuple(float(c) for c in color[:3])


def _rgb8(rgb) -> Tuple[int, int, int]:
    return tuple(int(round(255.0 * c)) for c in rgb[:3])


def colormap(name: str = "viridis"):
    """matplotlib's ``colormaps[name]`` for the one map the port keeps:
    values in [0, 1] → (N, 4) RGBA, as ``Colormap.__call__`` indexes its
    256-entry table (``int(x × 256)``, 1.0 → the last entry)."""
    if name != "viridis":
        raise NotImplementedError(f"plotting: only the viridis colormap, not {name!r}")

    def cmap(x):
        xa = np.array(x, dtype=np.float64, copy=True, ndmin=1)
        with np.errstate(invalid="ignore"):
            xa *= 256
            xa[xa == 256] = 255
            idx = np.clip(xa, -1, 256)
        idx = np.nan_to_num(idx, nan=0).astype(int)
        rgb = VIRIDIS[np.clip(idx, 0, 255)]
        return np.concatenate([rgb, np.ones(rgb.shape[:-1] + (1,))], axis=-1)

    return cmap


# ---------------------------------------------------------------------------
# matplotlib's limit arithmetic (transforms.nonsingular, the locators'
# nonsingular / view_limits, LogScale.limit_range_for_scale)
# ---------------------------------------------------------------------------


def _nonsingular(vmin, vmax, expander=0.001, tiny=1e-15):
    if not (np.isfinite(vmin) and np.isfinite(vmax)):
        return -expander, expander
    if vmax < vmin:
        vmin, vmax = vmax, vmin
    vmin, vmax = float(vmin), float(vmax)
    maxabs = max(abs(vmin), abs(vmax))
    if maxabs < (1e6 / tiny) * np.finfo(float).tiny:
        vmin, vmax = -expander, expander
    elif vmax - vmin <= maxabs * tiny:
        if vmax == 0 and vmin == 0:
            vmin, vmax = -expander, expander
        else:
            vmin -= expander * abs(vmin)
            vmax += expander * abs(vmax)
    return vmin, vmax


def _decade_less_equal(x):
    return x if x == 0 else (-_decade_greater_equal(-x) if x < 0
                             else 10.0 ** np.floor(np.log(x) / np.log(10.0)))


def _decade_greater_equal(x):
    return x if x == 0 else (-_decade_less_equal(-x) if x < 0
                             else 10.0 ** np.ceil(np.log(x) / np.log(10.0)))


def _decade_less(x):
    if x < 0:
        return -_decade_greater(-x)
    less = _decade_less_equal(x)
    return less / 10.0 if less == x else less


def _decade_greater(x):
    if x < 0:
        return -_decade_less(-x)
    greater = _decade_greater_equal(x)
    return greater * 10.0 if greater == x else greater


def _locator_nonsingular(scale, v0, v1, minpos):
    """``AutoLocator.nonsingular`` (linear) or ``LogLocator.nonsingular``."""
    if scale == "linear":
        return _nonsingular(v0, v1, expander=0.05)
    if v0 > v1:
        v0, v1 = v1, v0
    if not (np.isfinite(v0) and np.isfinite(v1)) or v1 <= 0:
        return 1, 10
    if not np.isfinite(minpos):
        minpos = 1e-300
    if v0 <= 0:
        v0 = minpos
    if v0 == v1:
        v0, v1 = _decade_less(v0), _decade_greater(v1)
    return v0, v1


def _view_limits(scale, v0, v1, minpos):
    """The locator's ``view_limits`` with ``axes.autolimit_mode`` 'data'."""
    if scale == "linear":
        return _nonsingular(v0, v1, expander=1e-12, tiny=1e-13)
    return _locator_nonsingular(scale, v0, v1, minpos)


def _limit_range(scale, v0, v1, minpos):
    if scale == "linear":
        return v0, v1
    if not np.isfinite(minpos):
        minpos = 1e-300
    return (minpos if v0 <= 0 else v0, minpos if v1 <= 0 else v1)


def _fwd(scale, v):
    if scale == "linear":
        return np.asarray(v, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.log10(v)


def _inv(scale, v):
    return np.asarray(v, dtype=np.float64) if scale == "linear" else np.power(10.0, v)


class _DataLim:
    """One axis of an Axes' ``dataLim``: its interval and smallest positive value."""

    def __init__(self, lo=np.inf, hi=-np.inf):
        self.lo, self.hi, self.minpos = lo, hi, np.inf

    def update(self, values: np.ndarray, ignore: bool) -> None:
        if ignore:
            self.lo, self.hi, self.minpos = np.inf, -np.inf, np.inf
        self.lo = min(self.lo, float(np.min(values, initial=np.inf)))
        self.hi = max(self.hi, float(np.max(values, initial=-np.inf)))
        self.minpos = min(self.minpos, float(np.min(values[values > 0], initial=np.inf)))


# ---------------------------------------------------------------------------
# text and drawing on a uint8 RGB canvas
# ---------------------------------------------------------------------------


def _font_scale(size_px: float) -> float:
    import cv2

    return size_px / cv2.getTextSize("Hg", cv2.FONT_HERSHEY_SIMPLEX, 1.0, 1)[0][1] * 0.72


def _text_size(text: str, size_px: float) -> Tuple[int, int]:
    """(width, height) in pixels of ``text`` at ``size_px`` (ascent + descent)."""
    import cv2

    if not text:
        return 0, 0
    (w, h), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, _font_scale(size_px), 1)
    return w, h + base


def _draw_text(img: np.ndarray, text: str, x: float, y: float, size_px: float,
               rgb=(0.0, 0.0, 0.0), ha: str = "left", va: str = "top",
               rotation: int = 0) -> None:
    """``text`` anchored at (x, y) by ``ha`` (left/center/right) and ``va``
    (top/center/bottom) of its box; ``rotation`` 90 turns it counter-clockwise."""
    import cv2

    if not text:
        return
    scale = _font_scale(size_px)
    (w, h), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, scale, 1)
    mask = np.zeros((h + base + 2, w + 2), np.uint8)
    cv2.putText(mask, text, (1, h + 1), cv2.FONT_HERSHEY_SIMPLEX, scale, 255, 1, cv2.LINE_AA)
    if rotation == 90:
        mask = np.rot90(mask)
    mh, mw = mask.shape
    x0 = int(round(x - {"left": 0, "center": mw / 2, "right": mw}[ha]))
    y0 = int(round(y - {"top": 0, "center": mh / 2, "bottom": mh}[va]))
    H, W = img.shape[:2]
    sx0, sy0, sx1, sy1 = max(0, -x0), max(0, -y0), min(mw, W - x0), min(mh, H - y0)
    if sx1 <= sx0 or sy1 <= sy0:
        return
    a = mask[sy0:sy1, sx0:sx1, None].astype(np.float32) / 255.0
    region = img[y0 + sy0:y0 + sy1, x0 + sx0:x0 + sx1]
    region[:] = np.round(region * (1 - a) + np.asarray(_rgb8(rgb), np.float32) * a)


def _polyline(img, pts: np.ndarray, rgb, thickness: int) -> None:
    """A polyline through the finite rows of ``pts`` (N, 2) pixels, broken
    at non-finite ones as matplotlib breaks a line at NaN."""
    import cv2

    ok = np.isfinite(pts).all(axis=1)
    start = None
    for i in range(len(pts) + 1):
        if i < len(pts) and ok[i]:
            start = i if start is None else start
            continue
        if start is not None:
            seg = np.round(pts[start:i] * 16).astype(np.int32)
            if len(seg) == 1:
                cv2.circle(img, tuple(int(v) for v in seg[0]), 16 * max(1, thickness // 2),
                           _rgb8(rgb), -1, cv2.LINE_8, 4)
            else:
                cv2.polylines(img, [seg], False, _rgb8(rgb), thickness, cv2.LINE_8, 4)
            start = None


def _pt_px(points: float, dpi: float) -> float:
    return points * dpi / 72.0


# ---------------------------------------------------------------------------
# 2D axes
# ---------------------------------------------------------------------------


class Axes:
    """A 2D axes: the artists the plot sites add, matplotlib's autoscale."""

    def __init__(self, fig: "Figure"):
        self.figure = fig
        self._lines: List[dict] = []       # plot / semilogy / axhline
        self._scatters: List[dict] = []
        self._bars: List[dict] = []
        self._lim = {"x": _DataLim(), "y": _DataLim()}
        self._ignore = True                # matplotlib's ignore_existing_data_limits
        self._view = {"x": (0.0, 1.0), "y": (0.0, 1.0)}
        self._mutated = {"x": False, "y": False}
        self._stale = {"x": False, "y": False}
        self._auto = {"x": True, "y": True}
        self._scale = {"x": "linear", "y": "linear"}
        self._shared = {"x": [self], "y": [self]}
        self._line_cycle = 0
        self._patch_cycle = 0
        self.title = self.xlabel = self.ylabel = ""
        self._legend: Optional[dict] = None
        self._grid: Optional[float] = None
        self._xticks: Optional[np.ndarray] = None
        self._xticklabels: Optional[Tuple[Sequence[str], int, float]] = None
        self._show_xticklabels = True
        self.box: Optional[Tuple[int, int, int, int]] = None   # (x0, y0, x1, y1) px, at savefig
        self.legend_box: Optional[Tuple[int, int, int, int]] = None

    # -- limits ----------------------------------------------------------------
    def _update_datalim(self, x, y, updatex=True, updatey=True) -> None:
        x = np.asarray(x, np.float64).ravel()
        y = np.asarray(y, np.float64).ravel()
        if x.size == 0:
            return
        valid = np.isfinite(x) & np.isfinite(y)
        if updatex:
            self._lim["x"].update(x[valid], self._ignore)
        if updatey:
            self._lim["y"].update(y[valid], self._ignore)
        self._ignore = False

    def _request_autoscale(self, *names) -> None:
        for name in names or ("x", "y"):
            for ax in self._shared[name]:
                ax._stale[name] = True

    def _unstale(self) -> None:
        need = {n: any(ax._stale[n] for ax in self._shared[n]) for n in ("x", "y")}
        if any(need.values()):
            for n in need:
                for ax in self._shared[n]:
                    ax._stale[n] = False
            self._autoscale(need["x"], need["y"])

    def _stickies(self, name: str) -> np.ndarray:
        """The sticky edges: a vertical bar's bottom, on the y axis only."""
        s = np.sort(np.asarray([v for ax in self._shared[name] for b in ax._bars
                                for v in b["sticky_y"]] if name == "y" else [], np.float64))
        return s[s > 0] if self._scale[name] == "log" else s

    def _autoscale(self, scalex: bool, scaley: bool) -> None:
        """matplotlib's ``Axes.autoscale_view`` with ``axes.autolimit_mode``
        'data' (matplotlib/axes/_base.py)."""
        for name, scale in (("x", scalex), ("y", scaley)):
            if not (scale and self._auto[name]):
                continue
            stickies = self._stickies(name)
            kind = self._scale[name]
            values = [v for ax in self._shared[name] for v in (ax._lim[name].lo, ax._lim[name].hi)
                      if np.isfinite(v)]
            if values:
                x0, x1 = min(values), max(values)
            elif self._mutated[name]:
                continue
            else:
                x0, x1 = -np.inf, np.inf
            minpos = min(ax._lim[name].minpos for ax in self._shared[name])
            x0, x1 = _locator_nonsingular(kind, x0, x1, minpos)
            tol = 1e-5 * abs(x1 - x0)
            i0 = stickies.searchsorted(x0 + tol) - 1
            x0bound = stickies[i0] if i0 != -1 else None
            i1 = stickies.searchsorted(x1 - tol)
            x1bound = stickies[i1] if i1 != len(stickies) else None
            x0, x1 = _limit_range(kind, x0, x1, minpos)
            x0t, x1t = _fwd(kind, [x0, x1])
            delta = (x1t - x0t) * _MARGIN
            if not np.isfinite(delta):
                delta = 0
            x0, x1 = (float(v) for v in _inv(kind, [x0t - delta, x1t + delta]))
            if x0bound is not None:
                x0 = max(x0, x0bound)
            if x1bound is not None:
                x1 = min(x1, x1bound)
            x0, x1 = _view_limits(kind, x0, x1, minpos)
            self._set_lim(name, x0, x1, auto=None)

    def _set_lim(self, name: str, v0, v1, auto) -> None:
        """``Axis._set_lim``: the locator's nonsingular, the scale's range,
        the limits shared with the sibling axes."""
        minpos = self._lim[name].minpos
        if self._scale[name] == "log" and (v0 <= 0 or v1 <= 0):
            old0, old1 = self._get_view(name)
            v0, v1 = (old0 if v0 <= 0 else v0), (old1 if v1 <= 0 else v1)
        reverse = bool(v0 > v1)
        v0, v1 = _locator_nonsingular(self._scale[name], v0, v1, minpos)
        v0, v1 = _limit_range(self._scale[name], v0, v1, minpos)
        v0, v1 = sorted([v0, v1], reverse=reverse)
        for ax in self._shared[name]:
            ax._view[name] = (v0, v1)
            ax._mutated[name] = True
            ax._stale[name] = False
            if auto is not None:
                ax._auto[name] = bool(auto)

    def _get_view(self, name):
        self._unstale()
        return self._view[name]

    def get_xlim(self) -> Tuple[float, float]:
        return tuple(float(v) for v in self._get_view("x"))

    def get_ylim(self) -> Tuple[float, float]:
        return tuple(float(v) for v in self._get_view("y"))

    def set_yscale(self, scale: str) -> None:
        if scale not in ("linear", "log"):
            raise NotImplementedError(f"plotting: {scale!r} scale")
        for ax in self._shared["y"]:
            ax._scale["y"] = scale
        if self._auto["y"]:
            self._request_autoscale("y")

    # -- artists -----------------------------------------------------------------
    def _next_line_color(self):
        c = TAB10[self._line_cycle % len(TAB10)]
        self._line_cycle += 1
        return c

    def _next_patch_color(self):
        c = TAB10[self._patch_cycle % len(TAB10)]
        self._patch_cycle += 1
        return c

    def plot(self, x, y, color=None, label=None):
        """A line (``Axes.plot(x, y)``); NaN breaks it."""
        x = np.asarray(x, np.float64).ravel()
        y = np.asarray(y, np.float64).ravel()
        color = color or self._next_line_color()
        self._lines.append({"x": x, "y": y, "color": to_rgb(color), "label": label,
                            "lw": _LINE_PT, "kind": "line"})
        self._update_datalim(x, y)
        self._request_autoscale()
        return self._lines[-1]

    def semilogy(self, x, y, **kwargs):
        """``Axes.semilogy``: a log y axis, then :meth:`plot`."""
        self.set_yscale("log")
        return self.plot(x, y, **kwargs)

    def scatter(self, x, y, s=None, c=None, label=None):
        """Filled circles of area ``s`` points² (``Axes.scatter``); its data
        limits are the points' box, as a PathCollection's offsets give them."""
        x = np.asarray(x, np.float64).ravel()
        y = np.asarray(y, np.float64).ravel()
        color = c or self._next_patch_color()
        self._scatters.append({"x": x, "y": y, "color": to_rgb(color), "label": label,
                               "s": _MARKER_PT2 if s is None else float(s)})
        valid = np.isfinite(x) & np.isfinite(y)
        xs, ys = x[valid], y[valid]
        corners = np.asarray([[np.min(xs, initial=np.inf), np.min(ys, initial=np.inf)],
                              [np.max(xs, initial=-np.inf), np.max(ys, initial=-np.inf)]])
        minpos = [np.min(xs[xs > 0], initial=np.inf), np.min(ys[ys > 0], initial=np.inf)]
        if not np.isinf(minpos).all():
            corners = np.concatenate([corners, [minpos]])
        if np.isfinite(corners).any():
            self._update_datalim(corners[:, 0], corners[:, 1])
        self._request_autoscale()
        return self._scatters[-1]

    def hist(self, x, bins=10):
        """``Axes.hist`` of one dataset, ``histtype='bar'``: ``np.histogram``'s
        counts as bars from 0, which is the y axis's sticky edge."""
        counts, edges = np.histogram(np.asarray(x, np.float64).ravel(), bins=bins)
        width = np.diff(edges)
        left = (edges[:-1] + 0.5 * width) - width / 2
        height = counts.astype(np.float64)
        color = to_rgb(self._next_patch_color())
        for l, w, h in zip(left, width, height):
            if w == 0 and h == 0:
                continue
            self._update_datalim([l, l + w, l + w, l], [0.0, 0.0, h, h])
        self._bars.append({"left": left, "width": width, "height": height, "color": color,
                           "label": None, "sticky_y": [0.0] * (2 * len(left))})
        self._request_autoscale()
        return counts, edges

    def axhline(self, y=0.0, color="black", lw=_LINE_PT):
        """A horizontal line across the axes; the y axis rescales only when
        ``y`` lies outside its limits of the moment (``Axes.axhline``)."""
        ymin, ymax = sorted(self.get_ylim())
        scaley = y < ymin or y > ymax
        self._lines.append({"y": float(y), "color": to_rgb(color), "lw": lw, "kind": "hline",
                            "label": None})
        self._update_datalim([0.0, 1.0], [y, y], updatex=False)
        if scaley:
            self._request_autoscale("y")
        return self._lines[-1]

    def set_xticks(self, ticks) -> None:
        """Fixed x ticks; the view grows to hold them (``Axis.set_ticks``)."""
        ticks = np.asarray(ticks, np.float64)
        for ax in self._shared["x"]:
            ax._xticks = ticks
        if len(ticks):
            for ax in self._shared["x"]:
                lo, hi = ax._get_view("x")
                if lo < hi:
                    ax._view["x"] = (min(ticks.min(), lo), max(ticks.max(), hi))
                else:
                    ax._view["x"] = (max(ticks.max(), lo), min(ticks.min(), hi))
                ax._mutated["x"] = True

    def set_xticklabels(self, labels, rotation=0, fontsize=None) -> None:
        self._xticklabels = ([str(s) for s in labels], int(rotation), fontsize or _FONT_PT)

    def set_xlabel(self, text) -> None:
        self.xlabel = str(text)

    def set_ylabel(self, text) -> None:
        self.ylabel = str(text)

    def set_title(self, text) -> None:
        self.title = str(text)

    def legend(self, loc="upper right", fontsize=None) -> None:
        self._legend = {"loc": loc, "fontsize": fontsize or _FONT_PT}

    def grid(self, visible=True, alpha=1.0) -> None:
        self._grid = float(alpha) if visible else None

    # -- drawing -----------------------------------------------------------------
    def _ticks(self, name: str, length_px: float, font_px: float):
        lo, hi = sorted(self._get_view(name))
        if name == "x" and self._xticks is not None:
            return self._xticks, None
        if self._scale[name] == "log":
            d0, d1 = math.ceil(math.log10(lo) - 1e-9), math.floor(math.log10(hi) + 1e-9)
            if d1 >= d0:
                step = max(1, (d1 - d0 + 1) // 8 + 1)
                return np.asarray([10.0 ** d for d in range(d0, d1 + 1, step)]), "log"
        n_max = max(2, min(9, int(length_px / (font_px * (4.0 if name == "x" else 2.0)))))
        raw = (hi - lo) / n_max
        mag = 10.0 ** math.floor(math.log10(raw)) if raw > 0 else 1.0
        step = next(m * mag for m in (1, 2, 2.5, 5, 10) if m * mag >= raw)
        t = np.arange(math.ceil(lo / step - 1e-9), math.floor(hi / step + 1e-9) + 1) * step
        return t, step

    @staticmethod
    def _tick_label(v: float, step) -> str:
        if step == "log":
            return f"1e{int(round(math.log10(v)))}"
        if step is None:
            return f"{v:g}"
        exponent = math.floor(math.log10(step) + 1e-9)
        decimals = max(0, -exponent + (1 if step / 10.0 ** exponent == 2.5 else 0))
        s = f"{v:.{decimals}f}"
        return "0" if s.lstrip("-").strip("0.") == "" else s

    def _map(self, name: str, v, lo_px: float, length_px: float) -> np.ndarray:
        kind = self._scale[name]
        v0, v1 = self._get_view(name)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (_fwd(kind, v) - _fwd(kind, v0)) / (_fwd(kind, v1) - _fwd(kind, v0))
            if kind == "log":
                t = np.where(np.asarray(v) > 0, t, np.nan)
        return lo_px + t * length_px

    def to_pixels(self, x, y) -> np.ndarray:
        """Data points → figure pixels (x right, y down) of the last savefig."""
        x0, y0, x1, y1 = self.box
        px = self._map("x", np.asarray(x, np.float64), x0, x1 - x0)
        py = self._map("y", np.asarray(y, np.float64), y1, -(y1 - y0))
        return np.stack([px, py], axis=-1)

    def _margins(self, dpi: float, height_px: float) -> Dict[str, float]:
        """The room, in pixels, that the labels around the axes take."""
        font = _pt_px(_FONT_PT, dpi)
        pad = _pt_px(4.0, dpi)
        yt, ystep = self._ticks("y", height_px, font)
        yw = max([_text_size(self._tick_label(v, ystep), font)[0] for v in yt] or [0])
        bottom = pad
        if self._show_xticklabels:
            if self._xticklabels is not None:
                labels, rot, size = self._xticklabels
                fpx = _pt_px(size, dpi)
                bottom += max((_text_size(s, fpx)[0] if rot == 90 else _text_size(s, fpx)[1])
                              for s in labels or [""]) + pad
            else:
                bottom += _text_size("0", font)[1] + pad
            if self.xlabel:
                bottom += _text_size(self.xlabel, font)[1] + pad
        left = yw + 2 * pad + (_text_size(self.ylabel, font)[1] + pad if self.ylabel else 0)
        top = pad + (_text_size(self.title, _pt_px(_TITLE_PT, dpi))[1] + pad if self.title else 0)
        return {"left": left, "bottom": bottom, "top": top, "right": 2 * pad}

    def _draw(self, img: np.ndarray, box, dpi: float) -> None:
        import cv2

        self.box = box
        x0, y0, x1, y1 = box
        W, H = x1 - x0, y1 - y0
        font = _pt_px(_FONT_PT, dpi)
        pad = _pt_px(3.5, dpi)
        canvas = np.full((H + 1, W + 1, 3), 255, np.uint8)
        xt, xstep = self._ticks("x", W, font)
        yt, ystep = self._ticks("y", H, font)
        grid = None if self._grid is None else (1 - self._grid) * np.ones(3) + self._grid * np.asarray(_GRID_RGB)
        if grid is not None:
            for v in xt:
                p = int(round(float(self._map("x", v, 0, W))))
                cv2.line(canvas, (p, 0), (p, H), _rgb8(grid), 1)
            for v in yt:
                p = int(round(float(self._map("y", v, H, -H))))
                cv2.line(canvas, (0, p), (W, p), _rgb8(grid), 1)
        for b in self._bars:
            for l, w, h in zip(b["left"], b["width"], b["height"]):
                px = self._map("x", np.asarray([l, l + w]), 0, W)
                py = self._map("y", np.asarray([0.0, h]), H, -H)
                if np.isfinite(px).all() and np.isfinite(py).all():
                    cv2.rectangle(canvas, (int(round(px[0])), int(round(py[1]))),
                                  (int(round(px[1])), int(round(py[0]))), _rgb8(b["color"]), -1)
        for line in self._lines:
            t = max(1, int(round(_pt_px(line["lw"], dpi))))
            if line["kind"] == "hline":
                p = float(self._map("y", line["y"], H, -H))
                pts = np.asarray([[0.0, p], [float(W), p]])
            else:
                pts = np.stack([self._map("x", line["x"], 0, W),
                                self._map("y", line["y"], H, -H)], axis=1)
            _polyline(canvas, pts, line["color"], t)
        for sc in self._scatters:
            r = max(1, int(round(_pt_px(math.sqrt(sc["s"]) / 2, dpi))))
            pts = np.stack([self._map("x", sc["x"], 0, W), self._map("y", sc["y"], H, -H)], axis=1)
            for p in pts[np.isfinite(pts).all(axis=1)]:
                cv2.circle(canvas, (int(round(p[0])), int(round(p[1]))), r, _rgb8(sc["color"]), -1)
        cv2.rectangle(canvas, (0, 0), (W, H), (0, 0, 0), 1)
        img[y0:y1 + 1, x0:x1 + 1] = canvas
        tick = int(round(_pt_px(3.5, dpi)))
        for v in xt:
            p = x0 + int(round(float(self._map("x", v, 0, W))))
            cv2.line(img, (p, y1), (p, y1 + tick), (0, 0, 0), 1)
        if self._show_xticklabels:
            if self._xticklabels is not None:
                labels, rot, size = self._xticklabels
                for v, s in zip(xt, labels):
                    p = x0 + float(self._map("x", v, 0, W))
                    _draw_text(img, s, p, y1 + tick + pad, _pt_px(size, dpi), ha="center",
                               va="top", rotation=rot)
                below = max([(_text_size(s, _pt_px(size, dpi))[0] if rot == 90 else
                              _text_size(s, _pt_px(size, dpi))[1]) for s in labels] or [0])
            else:
                for v in xt:
                    p = x0 + float(self._map("x", v, 0, W))
                    _draw_text(img, self._tick_label(v, xstep), p, y1 + tick + pad, font,
                               ha="center")
                below = _text_size("0", font)[1]
            if self.xlabel:
                _draw_text(img, self.xlabel, (x0 + x1) / 2, y1 + tick + 2 * pad + below, font,
                           ha="center")
        widest = 0
        for v in yt:
            p = y1 - int(round(float(self._map("y", v, 0, H))))
            cv2.line(img, (x0 - tick, p), (x0, p), (0, 0, 0), 1)
            s = self._tick_label(v, ystep)
            widest = max(widest, _text_size(s, font)[0])
            _draw_text(img, s, x0 - tick - pad, p, font, ha="right", va="center")
        if self.ylabel:
            _draw_text(img, self.ylabel, x0 - tick - 2 * pad - widest, (y0 + y1) / 2, font,
                       ha="right", va="center", rotation=90)
        if self.title:
            _draw_text(img, self.title, (x0 + x1) / 2, y0 - pad, _pt_px(_TITLE_PT, dpi),
                       ha="center", va="bottom")
        self._draw_legend(img, box, dpi)

    def _legend_entries(self):
        out = [(a["label"], a["color"], "line") for a in self._lines if a.get("label")]
        out += [(a["label"], a["color"], "marker") for a in self._scatters if a.get("label")]
        return out + [(a["label"], a["color"], "patch") for a in self._bars if a.get("label")]

    def _draw_legend(self, img, box, dpi) -> None:
        import cv2

        self.legend_box = None
        entries = self._legend_entries() if self._legend else []
        if not entries:
            return
        size = _pt_px(self._legend["fontsize"], dpi)
        pad = _pt_px(self._legend["fontsize"] * 0.5, dpi)
        handle = _pt_px(self._legend["fontsize"] * 2.0, dpi)
        row = max(_text_size(lbl, size)[1] for lbl, _, _ in entries) + pad * 0.5
        w = int(handle + 3 * pad + max(_text_size(lbl, size)[0] for lbl, _, _ in entries))
        h = int(row * len(entries) + 1.5 * pad)
        x0, y0, x1, y1 = box
        bx = x1 - w - int(pad) if "right" in self._legend["loc"] or self._legend["loc"] == "best" \
            else x0 + int(pad)
        by = y0 + int(pad)
        cv2.rectangle(img, (bx, by), (bx + w, by + h), (255, 255, 255), -1)
        cv2.rectangle(img, (bx, by), (bx + w, by + h), (204, 204, 204), 1)
        self.legend_box = (bx, by, bx + w, by + h)
        for k, (lbl, rgb, kind) in enumerate(entries):
            cy = by + pad + row * (k + 0.5)
            hx0, hx1 = bx + pad, bx + pad + handle
            if kind == "line":
                cv2.line(img, (int(hx0), int(cy)), (int(hx1), int(cy)), _rgb8(rgb),
                         max(1, int(round(_pt_px(_LINE_PT, dpi)))))
            elif kind == "marker":
                cv2.circle(img, (int((hx0 + hx1) / 2), int(cy)), max(2, int(size / 4)), _rgb8(rgb), -1)
            else:
                cv2.rectangle(img, (int(hx0), int(cy - size / 4)), (int(hx1), int(cy + size / 4)),
                              _rgb8(rgb), -1)
            _draw_text(img, lbl, hx1 + pad, cy, size, va="center")


# ---------------------------------------------------------------------------
# 3D axes (mpl_toolkits.mplot3d.axes3d.Axes3D and proj3d, matplotlib 3.10)
# ---------------------------------------------------------------------------


def _world_transformation(xmin, xmax, ymin, ymax, zmin, zmax, pb_aspect):
    dx, dy, dz = xmax - xmin, ymax - ymin, zmax - zmin
    ax, ay, az = pb_aspect
    dx /= ax
    dy /= ay
    dz /= az
    return np.array([[1 / dx, 0, 0, -xmin / dx],
                     [0, 1 / dy, 0, -ymin / dy],
                     [0, 0, 1 / dz, -zmin / dz],
                     [0, 0, 0, 1]])


def _norm_angle(a):
    a = (a + 360) % 360
    return a - 360 if a > 180 else a


def proj_transform(xs, ys, zs, M) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Points through a projection matrix (``proj3d.proj_transform``)."""
    xs, ys, zs = (np.asarray(v, np.float64) for v in (xs, ys, zs))
    vec = np.array([xs, ys, zs, np.ones_like(xs)])
    vecw = np.dot(M, vec)
    w = vecw[3]
    return vecw[0] / w, vecw[1] / w, vecw[2] / w


class Axes3D:
    """A 3D axes: mplot3d's limits and projection, painter's-order faces."""

    def __init__(self, fig: "Figure"):
        self.figure = fig
        self.elev, self.azim = 30.0, -60.0
        self._dist = 10.0
        self._focal_length = 1.0
        aspect = np.asarray((4, 4, 3), dtype=float)
        self._box_aspect = aspect * (1.8294640721620434 * 25 / 24 / np.linalg.norm(aspect))
        xymargin = 0.05 * 10 / 11
        self._lim = {"x": _DataLim(xymargin, 1 - xymargin), "y": _DataLim(xymargin, 1 - xymargin),
                     "z": _DataLim(0.0, 1.0)}
        self._view = {"x": (0.0, 1.0), "y": (0.0, 1.0), "z": (0.0, 1.0)}
        self._auto = {"x": True, "y": True, "z": True}
        self._artists: List[dict] = []
        self.title = ""
        self._legend = False
        self.box: Optional[Tuple[int, int, int, int]] = None
        self._autoscale()

    def view_init(self, elev=None, azim=None) -> None:
        self.elev = 30.0 if elev is None else float(elev)
        self.azim = -60.0 if azim is None else float(azim)

    # -- limits ------------------------------------------------------------------
    def _auto_scale_xyz(self, X, Y, Z, had_data: bool) -> None:
        X, Y, Z = (np.asarray(v, np.float64).ravel() for v in (X, Y, Z))
        valid = np.isfinite(X) & np.isfinite(Y)
        self._lim["x"].update(X[valid], not had_data)
        self._lim["y"].update(Y[valid], not had_data)
        self._lim["z"].update(Z[np.isfinite(Z)], not had_data)
        self._autoscale()

    def _autoscale(self) -> None:
        """mplot3d's ``autoscale_view``: the data's interval, nonsingular,
        5% margin, then ``set_bound`` with the view margin of 1/48."""
        for name in ("x", "y", "z"):
            if not self._auto[name]:
                continue
            v0, v1 = _nonsingular(self._lim[name].lo, self._lim[name].hi, expander=0.05)
            delta = (v1 - v0) * _MARGIN
            v0, v1 = _nonsingular(v0 - delta, v1 + delta, expander=1e-12, tiny=1e-13)
            v0, v1 = sorted((v0, v1))
            delta = (v1 - v0) * (1 / 48)
            self._set_lim(name, v0 - delta, v1 + delta, auto=None)

    def _set_lim(self, name, lower, upper, auto) -> None:
        if np.isinf(lower) or np.isinf(upper):
            raise ValueError(f"Axis limits {lower}, {upper} cannot be infinite")
        reverse = bool(lower > upper)
        v0, v1 = _nonsingular(lower, upper, expander=0.05)
        self._view[name] = tuple(sorted([v0, v1], reverse=reverse))
        if auto is not None:
            self._auto[name] = bool(auto)

    def set_xlim(self, left, right) -> None:
        self._set_lim("x", left, right, auto=False)

    def set_ylim(self, bottom, top) -> None:
        self._set_lim("y", bottom, top, auto=False)

    def set_zlim(self, bottom, top) -> None:
        self._set_lim("z", bottom, top, auto=False)

    def get_xlim(self):
        return tuple(float(v) for v in self._view["x"])

    def get_ylim(self):
        return tuple(float(v) for v in self._view["y"])

    def get_zlim(self):
        return tuple(float(v) for v in self._view["z"])

    def get_proj(self) -> np.ndarray:
        """The projection matrix of ``Axes3D.get_proj`` (vertical axis z,
        perspective with focal length 1)."""
        box_aspect = self._box_aspect
        worldM = _world_transformation(*self._view["x"], *self._view["y"], *self._view["z"],
                                       pb_aspect=box_aspect)
        R = 0.5 * box_aspect
        elev_rad, azim_rad = np.deg2rad(self.elev), np.deg2rad(self.azim)
        ps = np.array([np.cos(elev_rad) * np.cos(azim_rad), np.cos(elev_rad) * np.sin(azim_rad),
                       np.sin(elev_rad)])
        eye = R + self._dist * ps
        # the viewing axes (Axes3D._calc_view_axes, proj3d._view_axes)
        V = np.zeros(3)
        V[2] = -1 if abs(np.deg2rad(_norm_angle(self.elev))) > np.pi / 2 else 1
        w = eye - R
        w = w / np.linalg.norm(w)
        u = np.cross(V, w)
        u = u / np.linalg.norm(u)
        v = np.cross(w, u)
        eye_focal = R + self._dist * ps * self._focal_length
        Mr, Mt = np.eye(4), np.eye(4)
        Mr[:3, :3] = [u, v, w]
        Mt[:3, -1] = -eye_focal
        viewM = np.dot(Mr, Mt)
        zfront, zback, e = -self._dist, self._dist, self._focal_length
        projM = np.array([[e, 0, 0, 0], [0, e, 0, 0],
                          [0, 0, (zfront + zback) / (zfront - zback),
                           -2 * (zfront * zback) / (zfront - zback)],
                          [0, 0, -1, 0]])
        return np.dot(projM, np.dot(viewM, worldM))

    # -- artists -------------------------------------------------------------------
    def scatter(self, xs, ys, zs, s=20.0, c=None, label=None):
        had = bool(self._artists)
        color = c or TAB10[sum(a["kind"] == "scatter" for a in self._artists) % 10]
        pts = np.stack([np.asarray(v, np.float64).ravel() for v in (xs, ys, zs)], axis=1)
        self._artists.append({"kind": "scatter", "pts": pts, "color": to_rgb(color),
                              "s": float(s), "label": label})
        self._auto_scale_xyz(pts[:, 0], pts[:, 1], pts[:, 2], had)

    def plot(self, xs, ys, zs, c=None, lw=_LINE_PT, label=None):
        had = bool(self._artists)
        color = c or TAB10[sum(a["kind"] == "line" for a in self._artists) % 10]
        pts = np.stack([np.asarray(v, np.float64).ravel() for v in (xs, ys, zs)], axis=1)
        self._artists.append({"kind": "line", "pts": pts, "color": to_rgb(color), "lw": lw,
                              "label": label})
        self._auto_scale_xyz(pts[:, 0], pts[:, 1], pts[:, 2], had)

    def add_polygons(self, polys, facecolors) -> None:
        """Triangles (F, 3, 3) filled with (F, 3 or 4) colours, as a
        ``Poly3DCollection`` added with ``add_collection3d`` (autolim)."""
        had = bool(self._artists)
        polys = np.asarray(polys, np.float64)
        colors = np.asarray(facecolors, np.float64)
        if colors.ndim == 1:
            colors = np.broadcast_to(colors, (len(polys), colors.shape[0]))
        self._artists.append({"kind": "polys", "polys": polys, "colors": colors[:, :3],
                              "alpha": None, "label": None})
        self._auto_scale_xyz(polys[..., 0], polys[..., 1], polys[..., 2], had)

    def plot_trisurf(self, x, y, z, triangles, color=TAB10[0], edgecolor="none", alpha=None):
        """``Axes3D.plot_trisurf`` with ``shade=True``: each face's colour
        scaled into [0.3, 1] by its normal's dot product with mplot3d's
        default light. Faces have no edges here (``edgecolor="none"``)."""
        if edgecolor != "none":
            raise NotImplementedError("plotting: faces are drawn without edges")
        v = np.stack([np.asarray(a, np.float64).ravel() for a in (x, y, z)], axis=1)
        polys = v[np.asarray(triangles)]
        normals = np.cross(polys[:, 0] - polys[:, 1], polys[:, 1] - polys[:, 2])
        az, alt = np.radians(90 - 225), np.radians(19.4712)
        light = np.array([np.cos(az) * np.cos(alt), np.sin(az) * np.cos(alt), np.sin(alt)])
        with np.errstate(invalid="ignore"):
            shade = (normals / np.linalg.norm(normals, axis=1, keepdims=True)) @ light
        shade[np.isnan(shade)] = 0
        colors = ((shade + 1) / 2 * 0.7 + 0.3)[:, None] * np.asarray(to_rgb(color))[None]
        had = bool(self._artists)
        self._artists.append({"kind": "polys", "polys": polys, "colors": colors,
                              "alpha": alpha, "label": None})
        self._auto_scale_xyz(v[:, 0], v[:, 1], v[:, 2], had)

    def set_title(self, text) -> None:
        self.title = str(text)

    def legend(self) -> None:
        self._legend = True

    # -- drawing -------------------------------------------------------------------
    def project(self, pts: np.ndarray) -> np.ndarray:
        """(N, 3) data points → (N, 3) figure pixels (x, y) and depth, of the
        last savefig's layout."""
        x0, y0, x1, y1 = self.box
        xs, ys, zs = proj_transform(pts[:, 0], pts[:, 1], pts[:, 2], self.get_proj())
        lo, hi = -0.95 / self._dist, 0.9 / self._dist       # Axes3D.set_top_view
        px = x0 + (xs - lo) / (hi - lo) * (x1 - x0)
        py = y1 - (ys - lo) / (hi - lo) * (y1 - y0)
        return np.stack([px, py, zs], axis=1)

    def _draw(self, img: np.ndarray, box, dpi: float) -> None:
        import cv2

        self.box = box
        # the box's 12 edges, back panes first: light grey
        (xa, xb), (ya, yb), (za, zb) = self._view["x"], self._view["y"], self._view["z"]
        corners = np.array([[x, y, z] for x in (xa, xb) for y in (ya, yb) for z in (za, zb)])
        c = self.project(corners)
        for i in range(8):
            for j in range(i + 1, 8):
                if bin(i ^ j).count("1") == 1:
                    p, q = c[i, :2], c[j, :2]
                    cv2.line(img, (int(round(p[0])), int(round(p[1]))),
                             (int(round(q[0])), int(round(q[1]))), (200, 200, 200), 1, cv2.LINE_AA)
        items = []        # (depth, order, draw)
        for k, a in enumerate(self._artists):
            if a["kind"] == "polys":
                P = self.project(a["polys"].reshape(-1, 3)).reshape(len(a["polys"]), -1, 3)
                depth = P[..., 2].mean(axis=1)
                for f in np.argsort(depth)[::-1]:
                    items.append((depth[f], k, ("poly", P[f, :, :2], a["colors"][f], None)))
            elif a["kind"] == "scatter":
                P = self.project(a["pts"])
                r = max(1, int(round(_pt_px(math.sqrt(a["s"]) / 2, dpi))))
                for p in P:
                    items.append((p[2], k, ("dot", p[:2], a["color"], r)))
            else:
                P = self.project(a["pts"])
                t = max(1, int(round(_pt_px(a["lw"], dpi))))
                items.append((P[:, 2].mean(), k, ("line", P[:, :2], a["color"], t)))
        items.sort(key=lambda it: (-it[0], it[1]))
        layer = img.copy()
        for _, _, (kind, p, rgb, arg) in items:
            if kind == "poly":
                cv2.fillPoly(layer, [np.round(p * 16).astype(np.int32)], _rgb8(rgb), cv2.LINE_8, 4)
            elif kind == "dot":
                cv2.circle(layer, (int(round(p[0])), int(round(p[1]))), arg, _rgb8(rgb), -1)
            else:
                _polyline(layer, p, rgb, arg)
        # a surface's alpha over what lies behind the whole surface (the box),
        # not face over face
        alphas = [a["alpha"] for a in self._artists if a.get("alpha") is not None]
        if alphas:
            drawn = (layer != img).any(axis=2)
            a = min(alphas)
            img[drawn] = np.round(img[drawn] * (1 - a) + layer[drawn] * a)
        else:
            img[:] = layer
        if self.title:
            _draw_text(img, self.title, (box[0] + box[2]) / 2, box[1],
                       _pt_px(_TITLE_PT, dpi), ha="center", va="bottom")
        if self._legend:
            entries = [(a["label"], a["color"]) for a in self._artists if a.get("label")]
            size = _pt_px(_FONT_PT, dpi)
            row = _text_size("Hg", size)[1] + 4
            for k, (lbl, rgb) in enumerate(entries):
                y = box[1] + 8 + row * k + row // 2
                cv2.circle(img, (box[2] - 12 - _text_size(lbl, size)[0] - 10, int(y)), 4, _rgb8(rgb), -1)
                _draw_text(img, lbl, box[2] - 12, y, size, ha="right", va="center")


# ---------------------------------------------------------------------------
# figures
# ---------------------------------------------------------------------------


class Figure:
    """A figure of ``figsize`` inches: a grid of 2D axes or one 3D axes."""

    def __init__(self, figsize=None, dpi: float = _DPI):
        self.figsize = tuple(float(v) for v in (figsize or _FIGSIZE))
        self.dpi = float(dpi)
        self.axes: List = []

    def add_subplot(self, projection: Optional[str] = None):
        if projection not in (None, "3d"):
            raise NotImplementedError(f"plotting: projection {projection!r}")
        ax = Axes3D(self) if projection == "3d" else Axes(self)
        self.axes.append(ax)
        return ax

    def size_px(self, dpi: Optional[float] = None) -> Tuple[int, int]:
        """(width, height) of the saved image: ``int(figsize × dpi)``, as
        matplotlib's Agg canvas truncates them."""
        dpi = self.dpi if dpi is None else float(dpi)
        return int(self.figsize[0] * dpi), int(self.figsize[1] * dpi)

    def render(self, dpi: Optional[float] = None) -> np.ndarray:
        """The figure as an (H, W, 3) uint8 RGB image."""
        dpi = self.dpi if dpi is None else float(dpi)
        W, H = self.size_px(dpi)
        img = np.full((H, W, 3), 255, np.uint8)
        if not self.axes:
            return img
        if isinstance(self.axes[0], Axes3D):
            # the subplot box of the default subplot parameters, made square
            # and centred (Axes3D.apply_aspect)
            bw, bh = 0.775 * W, 0.77 * H
            side = min(bw, bh)
            cx, cy = (0.125 + 0.3875) * W, H - (0.11 + 0.385) * H
            box = (int(cx - side / 2), int(cy - side / 2), int(cx + side / 2), int(cy + side / 2))
            self.axes[0]._draw(img, box, dpi)
            return img
        margins = [ax._margins(dpi, 0.7 * H / len(self.axes)) for ax in self.axes]
        left = max(m["left"] for m in margins)
        right = max(m["right"] for m in margins)
        top = margins[0]["top"]
        bottom = margins[-1]["bottom"]
        gaps = [margins[i]["bottom"] + margins[i + 1]["top"] for i in range(len(margins) - 1)]
        h_each = (H - top - bottom - sum(gaps)) / len(self.axes)
        y = top
        for i, ax in enumerate(self.axes):
            box = (int(round(left)), int(round(y)), int(round(W - 1 - right)),
                   int(round(y + h_each)))
            ax._draw(img, box, dpi)
            y += h_each + (gaps[i] if i < len(gaps) else 0)
        return img

    def savefig(self, path, dpi: Optional[float] = None) -> None:
        """Writes the figure as an 8-bit RGBA PNG (opaque) of :meth:`size_px`
        pixels, the format matplotlib's Agg canvas writes."""
        from smilify_tpu_torch.utils.image_io import write_png

        img = self.render(dpi)
        write_png(path, np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1))


def figure(figsize=None) -> Figure:
    """``pyplot.figure``."""
    return Figure(figsize)


def subplots(nrows: int = 1, ncols: int = 1, figsize=None, sharex: bool = False,
             squeeze: bool = True):
    """``pyplot.subplots`` for a column of 2D axes: (figure, axes), the axes
    one object, a 1-D array, or with ``squeeze=False`` an (nrows, 1) array.
    ``sharex`` joins their x axes and hides the upper ones' tick labels."""
    if ncols != 1:
        raise NotImplementedError("plotting: one column of axes")
    fig = Figure(figsize)
    axes = [fig.add_subplot() for _ in range(nrows)]
    if sharex:
        for ax in axes:
            ax._shared["x"] = axes
        for ax in axes[:-1]:
            ax._show_xticklabels = False
    grid = np.empty((nrows, 1), dtype=object)
    for i, ax in enumerate(axes):
        grid[i, 0] = ax
    if not squeeze:
        return fig, grid
    return fig, axes[0] if nrows == 1 else grid[:, 0]
