"""Host-side IO: dataset parsing, synthetic scenes, prefetch pipeline.

Replaces the reference's io/ layer (iowrapperRGBD.cpp) minus live sensors
(out of scope for the device core — SURVEY.md §2.1 sensor rows; the dataset and
recorded-capture modalities are kept, live-sensor bridges are documented
interfaces).
"""

from revo_tpu.io.synthetic import SyntheticScene, render_frame
from revo_tpu.io.tum import (
    load_associations,
    load_tum_frame,
    write_tum_trajectory,
    read_tum_trajectory,
)

__all__ = [
    "SyntheticScene",
    "render_frame",
    "load_associations",
    "load_tum_frame",
    "write_tum_trajectory",
    "read_tum_trajectory",
]
