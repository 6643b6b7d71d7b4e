"""VAE temporal-ops experiment harness (JAX counterpart: experiments/;
reference: dynamic_enumeration*.py, run_experiments_*.sh,
analysis.ipynb)."""
from .analysis import (collect_experiment_metrics, frame_entropy,
                       parse_metrics_txt, rank_table, temporal_entropy_rate)
from .enumeration import base_config, enumerate_configs, write_configs
from .runner import (ExperimentResult, bucket_tensors, rank_results,
                     run_experiment, run_sweep)

__all__ = [
    "base_config", "enumerate_configs", "write_configs", "ExperimentResult",
    "bucket_tensors", "rank_results", "run_experiment", "run_sweep",
    "collect_experiment_metrics", "frame_entropy", "parse_metrics_txt",
    "rank_table", "temporal_entropy_rate",
]
