"""Seedable synthetic data generators (the churn, e-learning and
multi-class shapes)."""

from avenir_tpu_torch.data.generators import (
    churn_schema,
    elearn_schema,
    generate_churn,
    generate_elearn,
    generate_multiclass,
    multiclass_schema,
)

__all__ = ["churn_schema", "elearn_schema", "generate_churn", "generate_elearn",
           "generate_multiclass", "multiclass_schema"]
