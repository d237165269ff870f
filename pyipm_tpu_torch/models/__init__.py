from pyipm_tpu_torch.models.reference_problems import (  # noqa: F401
    REFERENCE_PROBLEMS, get_problem,
)
