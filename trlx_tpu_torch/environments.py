"""Multi-turn RL environments (the tool-use / agentic rollout API).

The port's own copy of the JAX package's `environments.py` (plain
Python; the port imports nothing of that package).

An `Environment` is the text-level counterpart of a gym env for
language rollouts: `reset(seed)` returns the opening observation (the
first prompt the policy sees), `step(action_text)` consumes one policy
turn and answers with an `EnvTurn` — the environment-authored message
appended to the conversation (tool output, game state, retrieval
result), the reward attributed to the policy turn just taken, and
whether the episode is over. The multi-turn experience makers
(`make_experience_multiturn`) drive episodes through fleet chat
sessions, so the conversation's KV stays resident server-side and each
policy turn prefills only the delta tokens.

Environments are deterministic given their reset seed — rollout
reproducibility and the smoke tests depend on it. Tokenization happens
in the trainer (environments speak text); environment-authored tokens
are masked out of the loss by the experience maker.

Reference environments:

- ``calculator`` — tool-use stub: an arithmetic question; the policy
  may call the tool with ``<calc>EXPR</calc>`` (the env answers with
  the evaluated result), and ends the episode by emitting a bare
  integer answer.
- ``retrieval`` — lookup stub: a question about a small fact table; the
  policy may issue ``<search>TERM</search>`` (the env returns matching
  facts) before answering.
- ``randomwalk`` — game stub in the spirit of the classic randomwalks
  task: walk a small ring graph to a goal node in few moves; each turn
  the policy names the next node.
"""

import random
import re
from dataclasses import dataclass
from typing import Callable, Dict, Optional

__all__ = [
    "EnvTurn",
    "Environment",
    "CalculatorEnv",
    "RetrievalEnv",
    "RandomWalkEnv",
    "register_environment",
    "make_environment",
]


@dataclass
class EnvTurn:
    """One environment response: the message the policy reads next, the
    reward for the policy turn that caused it, and episode termination.
    On ``done`` the `text` is informational only (never fed back)."""

    text: str
    reward: float
    done: bool


class Environment:
    """Protocol base. Subclasses implement `reset` and `step`; both are
    synchronous and single-episode (one instance = one concurrent
    episode; experience makers construct one env per conversation)."""

    def reset(self, seed: Optional[int] = None) -> str:
        """Start a fresh episode; returns the opening observation."""
        raise NotImplementedError

    def step(self, action_text: str) -> EnvTurn:
        """Consume one policy turn; returns the environment's reply."""
        raise NotImplementedError


_ENVIRONMENTS: Dict[str, Callable[..., Environment]] = {}


def register_environment(name: str):
    def wrap(cls):
        _ENVIRONMENTS[name] = cls
        return cls

    return wrap


def make_environment(name: str, **kwargs) -> Environment:
    """Instantiate a registered environment (`method.multiturn_env`)."""
    if name not in _ENVIRONMENTS:
        raise ValueError(
            f"unknown environment '{name}' (registered: "
            f"{sorted(_ENVIRONMENTS)})"
        )
    return _ENVIRONMENTS[name](**kwargs)


def _first_int(text: str) -> Optional[int]:
    m = re.search(r"-?\d+", text)
    return int(m.group()) if m else None


def _safe_arith(expr: str) -> Optional[int]:
    """Evaluate a left-folded integer +/-/* expression without eval
    (the calculator tool's whole vocabulary)."""
    tokens = re.findall(r"-?\d+|[+*-]", expr.replace(" ", ""))
    if not tokens:
        return None
    try:
        acc = int(tokens[0])
        for i in range(1, len(tokens) - 1, 2):
            op, rhs = tokens[i], int(tokens[i + 1])
            acc = acc + rhs if op == "+" else acc - rhs if op == "-" else acc * rhs
        return acc
    except (ValueError, IndexError):
        return None


@register_environment("calculator")
class CalculatorEnv(Environment):
    """Arithmetic with an optional calculator tool.

    Episode: "Q: what is A+B? A:". A policy turn containing
    ``<calc>EXPR</calc>`` is a tool call — the env evaluates EXPR and
    replies with ``= VALUE`` (reward 0, episode continues, up to
    `max_turns`). A turn containing a bare integer is the final answer:
    reward 1.0 when it matches, else 0.0, episode done."""

    def __init__(self, max_turns: int = 3, lo: int = 2, hi: int = 99):
        self.max_turns = int(max_turns)
        self.lo, self.hi = int(lo), int(hi)
        self._answer = 0
        self._turns = 0

    def reset(self, seed: Optional[int] = None) -> str:
        rng = random.Random(seed)
        a, b = rng.randint(self.lo, self.hi), rng.randint(self.lo, self.hi)
        self._answer = a + b
        self._turns = 0
        return f"Q: what is {a}+{b}? A:"

    def step(self, action_text: str) -> EnvTurn:
        self._turns += 1
        call = re.search(r"<calc>([^<]*)</calc>", action_text)
        if call is not None and self._turns < self.max_turns:
            val = _safe_arith(call.group(1))
            reply = f" = {val} " if val is not None else " = error "
            return EnvTurn(text=reply, reward=0.0, done=False)
        guess = _first_int(action_text)
        if guess is None and self._turns < self.max_turns:
            return EnvTurn(text=" Answer with a number: ", reward=0.0, done=False)
        return EnvTurn(
            text="",
            reward=1.0 if guess == self._answer else 0.0,
            done=True,
        )


@register_environment("retrieval")
class RetrievalEnv(Environment):
    """Fact lookup with an optional search tool.

    The env holds a tiny fact table; an episode asks for one entry's
    value. ``<search>TERM</search>`` turns get every fact line whose key
    contains TERM; a turn containing the exact value ends the episode
    with reward 1.0 (0.0 otherwise, or at `max_turns`)."""

    FACTS = {
        "aluminium": "13",
        "argon": "18",
        "iron": "26",
        "copper": "29",
        "silver": "47",
        "gold": "79",
    }

    def __init__(self, max_turns: int = 3):
        self.max_turns = int(max_turns)
        self._key = ""
        self._turns = 0

    def reset(self, seed: Optional[int] = None) -> str:
        rng = random.Random(seed)
        self._key = rng.choice(sorted(self.FACTS))
        self._turns = 0
        return f"Q: atomic number of {self._key}? A:"

    def step(self, action_text: str) -> EnvTurn:
        self._turns += 1
        call = re.search(r"<search>([^<]*)</search>", action_text)
        if call is not None and self._turns < self.max_turns:
            term = call.group(1).strip().lower()
            hits = [
                f"{k}={v}" for k, v in sorted(self.FACTS.items()) if term in k
            ]
            return EnvTurn(
                text=" [" + ("; ".join(hits) or "no results") + "] ",
                reward=0.0,
                done=False,
            )
        value = self.FACTS[self._key]
        hit = re.search(r"\d+", action_text)
        if hit is None and self._turns < self.max_turns:
            return EnvTurn(text=" Answer with a number: ", reward=0.0, done=False)
        return EnvTurn(
            text="",
            reward=1.0 if hit is not None and hit.group() == value else 0.0,
            done=True,
        )


@register_environment("randomwalk")
class RandomWalkEnv(Environment):
    """Ring-graph walk: reach the goal node in as few moves as possible.

    Nodes 0..n-1 on a ring; each turn the policy names the next node,
    which must be adjacent to the current one (non-adjacent or unparsable
    moves stay put). Reaching the goal ends the episode with reward 1.0;
    running out of turns scores by closeness; every intermediate move
    costs `step_penalty`."""

    def __init__(self, n_nodes: int = 10, max_turns: int = 6,
                 step_penalty: float = 0.05):
        self.n = int(n_nodes)
        self.max_turns = int(max_turns)
        self.step_penalty = float(step_penalty)
        self._pos = 0
        self._goal = 0
        self._turns = 0

    def _dist(self, a: int, b: int) -> int:
        d = abs(a - b)
        return min(d, self.n - d)

    def reset(self, seed: Optional[int] = None) -> str:
        rng = random.Random(seed)
        self._pos = rng.randrange(self.n)
        self._goal = (self._pos + rng.randint(2, self.n - 2)) % self.n
        self._turns = 0
        return (
            f"Ring of {self.n} nodes. You are at {self._pos}, goal {self._goal}. "
            f"Next node:"
        )

    def step(self, action_text: str) -> EnvTurn:
        self._turns += 1
        move = _first_int(action_text)
        if move is not None and self._dist(move % self.n, self._pos) == 1:
            self._pos = move % self.n
        if self._pos == self._goal:
            return EnvTurn(text="", reward=1.0, done=True)
        if self._turns >= self.max_turns:
            # partial credit for closeness when time runs out
            close = 1.0 - self._dist(self._pos, self._goal) / (self.n / 2.0)
            return EnvTurn(text="", reward=max(close, 0.0) * 0.5, done=True)
        return EnvTurn(
            text=f" now at {self._pos}, goal {self._goal}. Next node:",
            reward=-self.step_penalty,
            done=False,
        )
