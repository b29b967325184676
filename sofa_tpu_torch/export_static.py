"""``export``: static charts for sharing without a server (the JAX
package's ``sofa_tpu/export_static.py``).

One multi-page ``sofa_report.pdf``, and the overview page as
``overview.png``, drawn from the frames:

  overview   the GPU's kernel and tensor-core utilization and HBM rate
             (``gpuutil``) and the host CPU (``mpstat``)
  network    the five busiest interfaces (``netbandwidth``)
  blktrace   block IO latencies
  link       the estimated traffic between ranks (``link_matrix.csv`` of
             the ``comm_profile`` pass: NCCL over NVLink)
  top ops    the kernels with the most device time (``gputrace``)

A page without data is left out.  The pages are drawn by ``charts.py``
(a PDF writer and a rasterizer of its own), not matplotlib, which the
card's machine does not have; the PNG holds the plots and axes, the PDF
their text too.  Unlike the JAX package's export, this one does not
refresh the tile pyramid: ``report`` builds it from every frame, and a
refresh from the export's few frames would drop the others'.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import pandas as pd

from sofa_tpu_torch import charts
from sofa_tpu_torch.printing import print_progress, print_warning

# a fixed categorical order, assigned by entity, never cycled
C1, C2, C3, C4, C5 = "#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4"

STATIC_FRAMES = ["gpuutil", "mpstat", "netbandwidth", "blktrace",
                 "gputrace"]
# the plot area of a one-axes page, in points
_BOX = (90.0, 45.0, 590.0, 365.0)


def _series(ax: charts.Axes, df: pd.DataFrame, names: List[str],
            colors: List[str], scale: float = 1.0) -> bool:
    drew = False
    for name, color in zip(names, colors):
        rows = df[df["name"] == name] if not df.empty else df
        if rows.empty:
            continue
        # lanes (cores, devices) sharing a timestamp become one mean line
        agg = rows.groupby("timestamp")["event"].mean()
        ax.plot(agg.index.to_numpy(), agg.to_numpy() * scale, color, name)
        drew = True
    return drew


def _page_overview(page: charts.Canvas, frames) -> bool:
    util = frames.get("gpuutil", pd.DataFrame())
    mp = frames.get("mpstat", pd.DataFrame())
    rows = [(["kernel_util", "tensor_util"], [C1, C2], util,
             "GPU utilization", "%"),
            (["hbm_gbps"], [C3], util, "HBM bandwidth", "GB/s"),
            (["usr", "sys", "iow"], [C1, C2, C4], mp, "Host CPU", "%")]
    drew = False
    for i, (names, colors, df, title, unit) in enumerate(rows):
        top = 365.0 - i * 115.0
        ax = charts.Axes(page, 90.0, top - 85.0, 590.0, top)
        drew |= _series(ax, df, names, colors)
        ax.finish(title, xlabel="time (s)" if i == 2 else "", ylabel=unit)
    return drew


def _page_network(page: charts.Canvas, frames) -> bool:
    net = frames.get("netbandwidth", pd.DataFrame())
    if net.empty:
        return False
    ax = charts.Axes(page, *_BOX)
    # the busiest five, each (host, interface) its own line: a cluster
    # export keys the host in ``pid``
    multi_host = net["pid"].nunique() > 1
    keys = list(net.groupby(["pid", "name"])["event"].sum()
                .sort_values(ascending=False).head(5).index)
    for (hpid, name), color in zip(keys, (C1, C2, C3, C4, C5)):
        rows = net[(net["pid"] == hpid)
                   & (net["name"] == name)].sort_values("timestamp")
        label = f"h{int(hpid)}:{name}" if multi_host else name
        ax.plot(rows["timestamp"].to_numpy(),
                rows["event"].to_numpy() / 2 ** 20, color, label)
    ax.finish("Network bandwidth", "time (s)", "MiB/s")
    return bool(keys)


def _page_blktrace(page: charts.Canvas, frames) -> bool:
    blk = frames.get("blktrace", pd.DataFrame())
    if blk.empty:
        return False
    ax = charts.Axes(page, *_BOX)
    ax.scatter(blk["timestamp"].to_numpy(), blk["duration"].to_numpy() * 1e3,
               C1)
    ax.finish("Block IO latency", "time (s)", "ms")
    return True


def _page_link(page: charts.Canvas, cfg) -> bool:
    """The estimated traffic between ranks (NCCL over NVLink) over the
    ``link_matrix.csv`` the comm pass wrote, a single-hue ramp."""
    path = cfg.path("link_matrix.csv")
    if not os.path.isfile(path):
        return False
    try:
        mat = pd.read_csv(path, index_col=0)
    except Exception as e:  # noqa: BLE001 - an unreadable matrix skips the page
        print_warning(f"export: unreadable {path} ({e}); skipping the "
                      "link page")
        return False
    if mat.empty:
        return False
    ax = charts.Axes(page, 150.0, 45.0, 530.0, 365.0)
    ax.heat(mat.to_numpy(), list(mat.index), list(mat.columns),
            charts.ramp(["#fcfcfb", "#bcd6f2", "#2a78d6", "#12365f"]))
    ax.finish("Estimated NCCL traffic, src rank (rows) -> dst rank "
              "(columns); darkest = "
              f"{float(mat.to_numpy().max()) / 2 ** 20:.1f} MiB")
    return True


def _page_top_ops(page: charts.Canvas, frames) -> bool:
    ops = frames.get("gputrace", pd.DataFrame())
    if ops.empty:
        return False
    kern = ops[ops["category"] == 0]
    if kern.empty:
        return False
    top = (kern.groupby("name")["duration"].sum()
           .sort_values(ascending=False).head(12)[::-1])
    labels = [n if len(n) <= 40 else n[:20] + "..." + n[-17:]
              for n in top.index]
    ax = charts.Axes(page, 250.0, 45.0, 590.0, 365.0)
    ax.barh(labels, top.to_numpy() * 1e3, C1)
    ax.finish("Top kernels by total device time", "total time (ms)")
    return True


def export_static(cfg, frames: Optional[Dict[str, pd.DataFrame]] = None
                  ) -> List[str]:
    """Render sofa_report.pdf (and overview.png) into the logdir; returns
    the files written, empty (with a warning) when no page has data."""
    from sofa_tpu_torch.trace import atomic_replace

    if frames is None:
        from sofa_tpu_torch.preprocess import load_frames

        frames = load_frames(cfg, only=STATIC_FRAMES)
    os.makedirs(cfg.logdir, exist_ok=True)
    pdf_path = cfg.path("sofa_report.pdf")
    png_path = cfg.path("overview.png")
    pages = [
        ("overview", lambda c: _page_overview(c, frames)),
        ("network", lambda c: _page_network(c, frames)),
        ("blktrace", lambda c: _page_blktrace(c, frames)),
        ("link", lambda c: _page_link(c, cfg)),
        ("top_ops", lambda c: _page_top_ops(c, frames)),
    ]
    drawn: List[charts.Canvas] = []
    written: List[str] = []
    for name, render in pages:
        canvas = charts.Canvas()
        try:
            drew = render(canvas)
        except Exception as e:  # noqa: BLE001 - one page, not the export
            print_warning(f"export: page {name}: {e}")
            drew = False
        if not drew:
            continue
        drawn.append(canvas)
        if name == "overview":
            with atomic_replace(png_path) as tmp:
                charts.write_png(canvas, tmp)
            written.append(png_path)
    if not drawn:
        print_warning("export: no data to chart — run `report` first")
        return []
    with atomic_replace(pdf_path) as tmp:
        charts.write_pdf(drawn, tmp)
    written.insert(0, pdf_path)
    print_progress(f"exported {len(drawn)} chart pages -> {pdf_path}")
    return written
