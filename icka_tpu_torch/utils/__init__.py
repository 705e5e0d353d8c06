"""Host-side helpers (port of `icka_tpu.utils`): metric smoothing and
scalar logging, seeding, ranks, the logger and seekable TSV files."""

from icka_tpu_torch.utils.metric_logger import (MetricLogger, ScalarWriter,
                                                SmoothedValue)
from icka_tpu_torch.utils.misc import (get_rank, get_world_size,
                                       is_main_process, mkdir, set_seed,
                                       setup_logger)
from icka_tpu_torch.utils.tsv_file import TSVFile, tsv_writer

__all__ = ["SmoothedValue", "MetricLogger", "ScalarWriter", "set_seed",
           "mkdir", "get_rank", "get_world_size", "is_main_process",
           "setup_logger", "TSVFile", "tsv_writer"]
