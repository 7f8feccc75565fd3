"""The port's environments (`trlx_tpu_torch/environments.py`, its own copy)
against the JAX package's: the same registry names, and for every
environment over seeds and scripted action sequences, identical opening
observations and identical replies (text, reward, done) turn by turn."""

import pytest

from trlx_tpu import environments as j_env
from trlx_tpu_torch import environments as t_env

SCRIPTS = {
    "calculator": [
        ["<calc>12+30</calc>", "the answer is 42"],
        ["hmm", "no idea", "7"],
        ["<calc>3*4-5</calc>", "<calc>oops</calc>", "-3"],
        ["<calc>1+1</calc>", "<calc>2+2</calc>", "<calc>3+3</calc>", "100"],
    ],
    "retrieval": [
        ["<search>go</search>", "79"],
        ["<search>zz</search>", "I do not know", "26"],
        ["<search>ar</search>", "13"],
        ["18", "18"],
    ],
    "randomwalk": [
        ["1", "2", "3", "4", "5", "6"],
        ["9", "8", "7", "6", "5", "4"],
        ["x", "0", "11", "-1", "5", "3"],
        ["3"] * 6,
    ],
}
KWARGS = {"calculator": [{}, dict(max_turns=2, lo=0, hi=5)], "retrieval": [{}, dict(max_turns=2)],
          "randomwalk": [{}, dict(n_nodes=6, max_turns=4, step_penalty=0.1)]}


def test_registry_names_match_jax():
    assert sorted(t_env._ENVIRONMENTS) == sorted(j_env._ENVIRONMENTS) == ["calculator", "randomwalk", "retrieval"]
    assert t_env.__all__ == j_env.__all__
    with pytest.raises(ValueError, match="unknown environment"):
        t_env.make_environment("chess")


@pytest.mark.parametrize("name", sorted(SCRIPTS))
@pytest.mark.parametrize("kw", [0, 1])
@pytest.mark.parametrize("seed", [0, 1, 7, 123, None])
def test_episodes_match_jax(name, kw, seed):
    kwargs = KWARGS[name][kw]
    for script in SCRIPTS[name]:
        ours, theirs = t_env.make_environment(name, **kwargs), j_env.make_environment(name, **kwargs)
        if seed is None:
            # an unseeded reset draws from the OS: compare the step logic on
            # the same task instead
            obs = theirs.reset(None)
            ours.__dict__.update({k: v for k, v in theirs.__dict__.items()})
        else:
            obs = theirs.reset(seed)
            assert ours.reset(seed) == obs
        for action in script:
            a, b = ours.step(action), theirs.step(action)
            assert (a.text, a.reward, a.done) == (b.text, b.reward, b.done), (name, seed, action)
            if a.done:
                break


def test_registering_an_environment():
    @t_env.register_environment("echo_test")
    class Echo(t_env.Environment):
        def reset(self, seed=None):
            return "say something:"

        def step(self, action_text):
            return t_env.EnvTurn(text=action_text, reward=float(len(action_text)), done=True)

    try:
        env = t_env.make_environment("echo_test")
        assert env.reset(0) == "say something:"
        assert env.step("abc") == t_env.EnvTurn("abc", 3.0, True)
        assert "echo_test" not in j_env._ENVIRONMENTS
    finally:
        t_env._ENVIRONMENTS.pop("echo_test")
    with pytest.raises(NotImplementedError):
        t_env.Environment().reset()
