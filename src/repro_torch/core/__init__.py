"""Core GPIC library of the PyTorch port."""
from .affinity import AffinitySpec, as_affinity_spec, row_normalize_features
from .gpic import gpic
from .health import (
    COL_MAXITER,
    COL_NONFINITE,
    COL_OK,
    COL_STALLED,
    COL_ZERO,
    DegenerateGraphError,
    GPICError,
    HealthReport,
    InvalidInputError,
    NonFiniteInputError,
    PowerDivergenceError,
    count_bad_rows,
    describe_status,
)
from .kmeans import kmeans, kmeans_plus_plus_init
from .metrics import adjusted_rand_index, jaccard_index, purity, rand_index
from .operators import explicit_operator
from .pic import PICResult, make_pic_result
from .pipeline import ENGINES, GPICConfig, run_gpic
from .power import (
    EMBEDDINGS,
    PowerOperator,
    as_operator,
    batched_power_iteration,
    init_power_vectors,
    random_start_vectors,
    run_power_embedding,
    standardize_columns,
)

__all__ = [
    "AffinitySpec",
    "as_affinity_spec",
    "row_normalize_features",
    "gpic",
    "COL_OK",
    "COL_MAXITER",
    "COL_STALLED",
    "COL_NONFINITE",
    "COL_ZERO",
    "GPICError",
    "InvalidInputError",
    "NonFiniteInputError",
    "DegenerateGraphError",
    "PowerDivergenceError",
    "HealthReport",
    "count_bad_rows",
    "describe_status",
    "kmeans",
    "kmeans_plus_plus_init",
    "adjusted_rand_index",
    "jaccard_index",
    "purity",
    "rand_index",
    "explicit_operator",
    "PICResult",
    "make_pic_result",
    "ENGINES",
    "GPICConfig",
    "run_gpic",
    "EMBEDDINGS",
    "PowerOperator",
    "as_operator",
    "batched_power_iteration",
    "init_power_vectors",
    "random_start_vectors",
    "run_power_embedding",
    "standardize_columns",
]
