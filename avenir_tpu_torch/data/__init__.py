"""Seedable synthetic data generators (the churn and e-learning shapes)."""

from avenir_tpu_torch.data.generators import (
    churn_schema,
    elearn_schema,
    generate_churn,
    generate_elearn,
)

__all__ = ["churn_schema", "elearn_schema", "generate_churn", "generate_elearn"]
