"""Seedable synthetic data generators (the churn, e-learning,
call-hangup and multi-class shapes, the GSP token sequences, the event
sequences and the Markov tutorials' chains and HMM)."""

from avenir_tpu_torch.data.generators import (
    call_hangup_schema,
    churn_schema,
    elearn_schema,
    generate_call_hangup,
    generate_churn,
    generate_elearn,
    generate_event_sequences,
    generate_loyalty_sequences,
    generate_markov_chains,
    generate_multiclass,
    generate_token_sequences,
    multiclass_schema,
)

__all__ = ["call_hangup_schema", "churn_schema", "elearn_schema",
           "generate_call_hangup", "generate_churn", "generate_elearn",
           "generate_event_sequences", "generate_loyalty_sequences",
           "generate_markov_chains", "generate_multiclass",
           "generate_token_sequences",
           "multiclass_schema"]
