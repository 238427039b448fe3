"""Deterministic synthetic workloads and the LM token pipeline (numpy
generators; port of ``repro.data``)."""
from repro_torch.data.workloads import (  # noqa: F401
    WorkloadConfig,
    make_workload,
    sql_dump_versions,
    vmdk_versions,
    kernel_versions,
)
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig  # noqa: F401
