"""``paddle.v2.plot`` — counterpart of ``paddle_tpu/v2/plot.py``: the
training-curve helper (reference: python/paddle/v2/plot/plot.py
Ploter/PlotData).

The series are always collected; ``plot()`` draws them only where
``matplotlib`` imports (it is imported when a ``Ploter`` is made, not with
this module) and ``DISABLE_PLOT`` is not ``True``, as in the reference."""

from __future__ import annotations

import os

__all__ = ["Ploter", "PlotData"]


class PlotData:
    def __init__(self):
        self.step = []
        self.value = []

    def append(self, step, value):
        self.step.append(step)
        self.value.append(value)

    def reset(self):
        self.step = []
        self.value = []


class Ploter:
    """Collects (step, value) series by title and redraws on ``plot()``."""

    def __init__(self, *titles):
        self.__args__ = titles
        self.__plot_data__ = {t: PlotData() for t in titles}
        self._plt = None
        if os.environ.get("DISABLE_PLOT") != "True":
            try:
                import matplotlib
                matplotlib.use("Agg")  # no display needed
                import matplotlib.pyplot as plt

                self._plt = plt
            except Exception:
                self._plt = None

    def append(self, title, step, value):
        if title not in self.__plot_data__:
            raise ValueError(
                f"unknown plot title {title!r}; declared: {self.__args__}")
        self.__plot_data__[title].append(step, value)

    def plot(self, path=None):
        if self._plt is None:
            return
        self._plt.figure()
        for title in self.__args__:
            d = self.__plot_data__[title]
            self._plt.plot(d.step, d.value, label=title)
        self._plt.legend()
        if path:
            self._plt.savefig(path)
        self._plt.close()

    def reset(self):
        for d in self.__plot_data__.values():
            d.reset()
