"""The port's parameters handler (``utils/params.py``, a copy) against
``blf_tpu.utils.params``, and ``contact.params_from_handler`` against the
reference's.

Each case builds the same handler on both sides (from a dict, from ``.ini``
text with the reference's fixtures, from TOML) and asks both the same
question: the same value of the same type, or the same exception type.
"""

import numpy as np
import pytest
import torch

from blf_tpu.models import contact as jcontact
from blf_tpu.utils import params as jparams
from blf_tpu_torch.estimators.rls import init_from_handler
from blf_tpu_torch.models import contact as tcontact
from blf_tpu_torch.utils import params as tparams

torch.set_num_threads(1)

DATA = {"answer": 42, "pi": 3.14, "flag": True, "John": "Smith",
        "Fibonacci Numbers": [1, 1, 2, 3, 5, 8, 13, 21], "whole": 2.0,
        "CARTOONS": {"Donald's nephews": ["Huey", "Dewey", "Louie"], "John": "Doe",
                     "deeper": {"deep": 7}}}
GROUP_INI = """\
answer_to_the_ultimate_question_of_life 42
pi                                      3.14
John                                    Smith
"Fibonacci Numbers"                     (1, 1, 2, 3, 5, 8, 13, 21)
// a comment
enabled true
# another
[CARTOONS]
"Donald's nephews"                      ("Huey", "Dewey", "Louie")
Fibonacci_Numbers                       (1, 1, 2, 3, 5, 8, 13, 21)
John                                    Doe
"""
TOML = """\
lambda = 1.0
state = [0.0, 0.0]
[CONTACT]
length = 0.12
width = 0.09
spring_coeff = 2000
damper_coeff = 100.0
"""
CONTACT = {"length": 0.12, "width": 0.09, "spring_coeff": 2000.0, "damper_coeff": 100}


def both(kind):
    """The same handler from each package."""
    if kind == "dict":
        return tparams.ParametersHandler(DATA), jparams.ParametersHandler(DATA)
    if kind == "ini":
        return tparams.IniHandler.from_string(GROUP_INI), jparams.IniHandler.from_string(GROUP_INI)
    return tparams.TomlHandler.from_string(TOML), jparams.TomlHandler.from_string(TOML)


def outcome(fn):
    """``(value, type)`` of a call, or the exception type it raised."""
    try:
        value = fn()
    except (KeyError, TypeError) as err:
        return type(err)
    return value, type(value)


QUESTIONS = [
    ("dict", lambda h: h.get_parameter("answer", int)),
    ("dict", lambda h: h.get_parameter("answer", float)),
    ("dict", lambda h: h.get_parameter("pi", float)),
    ("dict", lambda h: h.get_parameter("pi", int)),
    ("dict", lambda h: h.get_parameter("whole", int)),
    ("dict", lambda h: h.get_parameter("pi", str)),
    ("dict", lambda h: h.get_parameter("flag", bool)),
    ("dict", lambda h: h.get_parameter("flag", int)),
    ("dict", lambda h: h.get_parameter("flag", float)),
    ("dict", lambda h: h.get_parameter("John", str)),
    ("dict", lambda h: h.get_parameter("John", int)),
    ("dict", lambda h: h.get_parameter("missing")),
    ("dict", lambda h: h.get_parameter("answer")),
    ("dict", lambda h: h.get_vector("Fibonacci Numbers", int)),
    ("dict", lambda h: h.get_vector("pi")),
    ("dict", lambda h: h.get_parameter("Fibonacci Numbers", list)),
    ("dict", lambda h: h.get_parameter("pi", list)),
    ("dict", lambda h: tuple(h.get_array("Fibonacci Numbers"))),
    ("dict", lambda h: h.get_group("CARTOONS").get_vector("Donald's nephews", str)),
    ("dict", lambda h: h.get_group("CARTOONS").get_group("deeper").get_parameter("deep", int)),
    ("dict", lambda h: h.get_group("MISSING")),
    ("dict", lambda h: (h.has_parameter("pi"), h.has_group("CARTOONS"), h.has_group("pi"))),
    ("dict", lambda h: (tuple(h.parameter_names()), tuple(h.group_names()))),
    ("dict", lambda h: h.to_string()),
    ("dict", lambda h: str(h.to_dict())),
    ("dict", lambda h: h.get_parameter("pi", dict)),
    ("ini", lambda h: h.get_parameter("answer_to_the_ultimate_question_of_life", int)),
    ("ini", lambda h: h.get_parameter("pi", float)),
    ("ini", lambda h: h.get_vector("Fibonacci Numbers", int)),
    ("ini", lambda h: h.get_parameter("enabled", bool)),
    ("ini", lambda h: h.get_group("CARTOONS").get_parameter("John", str)),
    ("ini", lambda h: h.get_group("CARTOONS").get_vector("Donald's nephews", str)),
    ("ini", lambda h: h.get_group("CARTOONS").get_parameter("Fibonacci_Numbers", int)),
    ("toml", lambda h: h.get_parameter("lambda", float)),
    ("toml", lambda h: h.get_vector("state", float)),
    ("toml", lambda h: h.get_group("CONTACT").get_parameter("spring_coeff", float)),
    ("toml", lambda h: h.get_group("CONTACT").get_parameter("missing_param", float)),
]


@pytest.mark.parametrize("kind, question", QUESTIONS,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(QUESTIONS)])
def test_same_answer_as_the_reference(kind, question):
    port, ref = both(kind)
    assert outcome(lambda: question(port)) == outcome(lambda: question(ref))


def test_parse_ini_returns_the_reference_dict():
    assert tparams.parse_ini(GROUP_INI) == jparams.parse_ini(GROUP_INI)


@pytest.mark.parametrize("package", [tparams, jparams], ids=["port", "blf_tpu"])
def test_groups_are_shared_by_reference_and_cleared(package):
    h = package.StdHandler({"a": 1})
    group = package.StdHandler()
    h.set_group("CARTOONS", group)
    assert h.get_group("CARTOONS").is_empty()
    group.set_parameter("John", "Doe")
    assert h.get_group("CARTOONS").get_parameter("John", str) == "Doe"
    h.get_group("CARTOONS").set_parameter("value", (1, 2))
    assert group.get_vector("value", int) == [1, 2]
    with pytest.raises(TypeError):
        h.set_group("bad", {"not": "a handler"})
    with pytest.raises(TypeError):
        h.set_parameter("bad", package.StdHandler())
    h.clear()
    assert h.is_empty()


def test_the_port_handler_is_its_own_copy():
    assert tparams.StdHandler is tparams.ParametersHandler
    assert not issubclass(tparams.ParametersHandler, jparams.ParametersHandler)
    assert tparams.ParametersHandler({"x": 1}) == tparams.ParametersHandler({"x": 1})


def test_params_from_handler_matches_the_reference():
    port = tcontact.params_from_handler(tparams.ParametersHandler(CONTACT), device="cpu",
                                        dtype=torch.float64)
    ref = jcontact.params_from_handler(jparams.ParametersHandler(CONTACT))
    assert type(port) is tcontact.ContactParams
    for name in tcontact.ContactParams._fields:
        value = getattr(port, name)
        assert value.dtype == torch.float64 and value.shape == ()
        np.testing.assert_array_equal(value.numpy(), np.asarray(getattr(ref, name)))
    grouped = tparams.TomlHandler.from_string(TOML).get_group("CONTACT")
    assert float(tcontact.params_from_handler(grouped, device="cpu").spring_coeff) == 2000.0
    for bad, error in (({k: v for k, v in CONTACT.items() if k != "width"}, KeyError),
                       ({**CONTACT, "length": "long"}, TypeError)):
        with pytest.raises(error):
            tcontact.params_from_handler(tparams.ParametersHandler(bad), device="cpu")
        with pytest.raises(error):
            jcontact.params_from_handler(jparams.ParametersHandler(bad))


def test_rls_reads_the_reference_keys_from_the_port_handler():
    """``init_from_handler`` on the port's own handler, built from the RLS
    fixture ``.ini`` of the reference's tests."""
    ini = "lambda 1.0\nmeasurement_covariance (0.5, 0.5)\nstate (0.0, 0.0)\n" \
          "state_covariance (10.0, 10.0)\n"
    params, state = init_from_handler(tparams.IniHandler.from_string(ini), device="cpu",
                                      dtype=torch.float64)
    np.testing.assert_array_equal(params.measurement_covariance.numpy(), 0.5 * np.eye(2))
    np.testing.assert_array_equal(state.covariance.numpy(), 10.0 * np.eye(2))
    assert float(params.lam) == 1.0 and state.theta.shape == (2,)
