"""The tutorials' generators of the port against the JAX package's.

The price ladder, hospital readmission, disease, buy-transaction (with
its state-sequence encoding) and visit-history families of
`avenir_tpu_torch.data` give the reference's rows for a seed, string for
string, at three seeds and two sizes; the two schemas are the same JSON,
and the CSV texts parse into the same Datasets.
"""

import numpy as np
import pytest

import avenir_tpu.data as jdata
import avenir_tpu_torch.data as pdata

SEEDS = [3, 17, 2026]


def _rows(mod, family, size, seed):
    if family == "price_opt":
        return mod.generate_price_opt(num_products=size, seed=seed)
    if family == "hosp_readmit":
        return mod.generate_hosp_readmit(size, seed=seed, as_csv=True)
    if family == "disease":
        return mod.generate_disease(size, seed=seed, as_csv=True)
    if family == "buy_xactions":
        rows = mod.generate_buy_xactions(n_cust=size, days=90, seed=seed)
        return rows, mod.xactions_to_state_sequences(rows)
    return (mod.generate_visit_history(size, seed=seed),
            mod.generate_visit_history(size, conv_rate=40, labeled=False,
                                       seed=seed))


SIZES = {"price_opt": (3, 25), "hosp_readmit": (50, 2000),
         "disease": (50, 2000), "buy_xactions": (40, 400),
         "visit_history": (30, 500)}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("size_index", [0, 1])
@pytest.mark.parametrize("family", sorted(SIZES))
def test_generator_rows_equal_reference(family, size_index, seed):
    size = SIZES[family][size_index]
    got = _rows(pdata, family, size, seed)
    assert got == _rows(jdata, family, size, seed)
    assert got                                  # not vacuously equal


def test_buy_states_and_schemas_equal_reference():
    assert pdata.BUY_STATES == jdata.BUY_STATES
    assert pdata.hosp_readmit_schema().to_json() == \
        jdata.hosp_readmit_schema().to_json()
    assert pdata.disease_schema().to_json() == jdata.disease_schema().to_json()


@pytest.mark.parametrize("family", ["hosp_readmit", "disease"])
def test_datasets_parse_as_reference(family):
    gen = getattr(pdata, f"generate_{family}")
    jgen = getattr(jdata, f"generate_{family}")
    ds, jds = gen(300, seed=5), jgen(300, seed=5)
    assert list(ds.ids()) == list(jds.ids())
    np.testing.assert_array_equal(ds.labels(), jds.labels())
    for f in ds.schema.feature_fields:
        np.testing.assert_array_equal(np.asarray(ds.column(f.ordinal)),
                                      np.asarray(jds.column(f.ordinal)))
