"""Seedable synthetic data generators (the churn, e-learning,
call-hangup and multi-class shapes, the tutorials' price ladder, hospital
readmission, disease, buy-transaction and visit-history rows, the GSP
token sequences, the event sequences and the Markov tutorials' chains and
HMM)."""

from avenir_tpu_torch.data.generators import (
    BUY_STATES,
    call_hangup_schema,
    churn_schema,
    disease_schema,
    elearn_schema,
    generate_buy_xactions,
    generate_call_hangup,
    generate_churn,
    generate_disease,
    generate_elearn,
    generate_event_sequences,
    generate_hosp_readmit,
    generate_loyalty_sequences,
    generate_markov_chains,
    generate_multiclass,
    generate_price_opt,
    generate_token_sequences,
    generate_visit_history,
    hosp_readmit_schema,
    multiclass_schema,
    xactions_to_state_sequences,
)

__all__ = [
    "BUY_STATES",
    "call_hangup_schema",
    "churn_schema",
    "disease_schema",
    "elearn_schema",
    "generate_buy_xactions",
    "generate_call_hangup",
    "generate_churn",
    "generate_disease",
    "generate_elearn",
    "generate_event_sequences",
    "generate_hosp_readmit",
    "generate_loyalty_sequences",
    "generate_markov_chains",
    "generate_multiclass",
    "generate_price_opt",
    "generate_token_sequences",
    "generate_visit_history",
    "hosp_readmit_schema",
    "multiclass_schema",
    "xactions_to_state_sequences",
]
