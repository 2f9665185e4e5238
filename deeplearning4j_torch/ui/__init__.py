"""Observability/UI pipeline (port of ``deeplearning4j_tpu/ui``;
reference: deeplearning4j-ui-parent).

listener -> storage -> web:

- ``StatsListener`` (stats.py) collects per-iteration score, parameter /
  update norms, timings, memory (reference:
  ui-model/.../stats/BaseStatsListener.java:44,297-381)
- ``StatsStorage`` API + InMemory/File impls (storage.py; reference:
  deeplearning4j-core api/storage/StatsStorage.java:30,
  ui-model InMemoryStatsStorage / FileStatsStorage.java:15). Wire format is
  JSON (replacing the reference's SBE codegen — no native codec needed).
- ``RemoteUIStatsStorageRouter`` posts updates over HTTP (remote.py;
  reference: api/storage/impl/RemoteUIStatsStorageRouter.java:33)
- ``UIServer`` (server.py) serves the stored stats as JSON + a static
  overview page (reference: deeplearning4j-play PlayUIServer.java:53 —
  stdlib http.server instead of the Play framework).
"""

from deeplearning4j_torch.ui.stats import StatsListener, StatsReport
from deeplearning4j_torch.ui.storage import (
    FileStatsStorage,
    InMemoryStatsStorage,
    StatsStorage,
    StatsStorageRouter,
)
from deeplearning4j_torch.ui.remote import RemoteUIStatsStorageRouter
from deeplearning4j_torch.ui.server import UIServer
from deeplearning4j_torch.ui.components import (
    ChartHistogram,
    ChartHorizontalBar,
    ChartLine,
    ChartMatrix,
    ChartScatter,
    ChartStackedArea,
    Component,
    ComponentDiv,
    ComponentTable,
    ComponentText,
    render_html,
    render_html_file,
)
from deeplearning4j_torch.ui.legacy import (
    ConvolutionalIterationListener,
    FlowIterationListener,
    HistogramIterationListener,
)

__all__ = [
    "StatsListener", "StatsReport", "StatsStorage", "StatsStorageRouter",
    "InMemoryStatsStorage", "FileStatsStorage", "RemoteUIStatsStorageRouter",
    "UIServer",
    "Component", "ComponentDiv", "ComponentTable", "ComponentText",
    "ChartLine", "ChartScatter", "ChartHistogram", "ChartHorizontalBar",
    "ChartStackedArea", "ChartMatrix", "render_html", "render_html_file",
    "HistogramIterationListener", "FlowIterationListener",
    "ConvolutionalIterationListener",
]
