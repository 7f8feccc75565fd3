"""ILQL loss: Q-target fitting, expectile V regression, conservative
Q-learning (CQL) and AWAC-weighted cross-entropy.

Port of the JAX package's `ops/ilql.py` (`topk_mask`,
`batched_index_select`, `ilql_loss_terms`, `ilql_loss` and its stats),
the causal path. The cross-entropy terms stay plain torch, as they are
plain `log_softmax` outside any Pallas kernel in the JAX package. The
sequence-parallel decomposition (`ilql_fullwidth_terms`) waits with
1F1B and sequence parallelism (ROADMAP queue A, item 4).
"""

from typing import Dict, Sequence, Tuple

import torch

from trlx_tpu_torch.utils.modeling import get_tensor_stats


def topk_mask(xs: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the top-k entries of the last axis, set the rest to -inf."""
    if k >= xs.shape[-1]:
        return xs
    mintop = torch.topk(xs, k, dim=-1).values[..., -1:]
    return torch.where(xs < mintop, torch.full_like(xs, -float("inf")), xs)


def batched_index_select(x: torch.Tensor, idxs: torch.Tensor) -> torch.Tensor:
    """Gather vectors at `idxs` along the sequence axis. x [b, t, d], idxs
    [b, n] -> [b, n, d]."""
    return torch.gather(x, 1, idxs.long()[..., None].expand(-1, -1, x.shape[-1]))


def _taken(x: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """x [b, n, V] at the taken actions [b, n] -> [b, n]."""
    return torch.gather(x, -1, actions[..., None])[..., 0]


def ilql_loss_terms(
    logits: torch.Tensor,  # [b, t, V] over the full sequence
    qs: Sequence[torch.Tensor],  # each [b, n_actions, V]
    target_qs: Sequence[torch.Tensor],  # each [b, n_actions, V]
    vs: torch.Tensor,  # [b, n_states, 1] (n_states = n_actions + 1)
    input_ids: torch.Tensor,  # [b, t]
    actions_ixs: torch.Tensor,  # [b, n_actions]
    dones: torch.Tensor,  # [b, n_states]
    rewards: torch.Tensor,  # [b, n_actions]
    tau: float,
    gamma: float,
    beta: float = 0.0,
) -> Tuple[Dict, Dict]:
    """The sums of the ILQL objective's terms over the batch (everything
    but the division by the count of nonterminal actions). Returns (terms,
    aux): scalar sums, and the per-action V, Q and terminal mask the stats
    read."""
    terminal_mask = dones[:, :-1].float()  # [b, n_actions]
    actions_ixs = actions_ixs.long()
    # the token taken at each action position
    actions = torch.gather(input_ids[:, 1:].long(), 1, actions_ixs)

    Q = [_taken(q, actions) for q in qs]
    target_q = _taken(target_qs[0], actions).detach()
    for tq in target_qs[1:]:
        target_q = torch.minimum(target_q, _taken(tq, actions).detach())

    V = vs[:, :-1, 0]  # values of the current states
    v_next = vs[:, 1:, 0] * dones[:, 1:].to(vs.dtype)  # 0 past the end
    q_target = rewards + gamma * v_next.detach()

    q_sum = sum((((qi - q_target) ** 2) * terminal_mask).sum() for qi in Q)

    # expectile regression of V toward the smaller target Q
    diff = target_q - V
    v_sum = ((torch.where(diff >= 0, tau, 1 - tau) * diff ** 2) * terminal_mask).sum()

    def cql_sum(q):
        # cross-entropy of the Q "logits" against the taken actions
        nll = -_taken(torch.log_softmax(q.float(), dim=-1), actions)
        return (nll * terminal_mask).sum()

    # AWAC: the LM's cross-entropy at the action positions, weighted by
    # exp(beta * advantage)
    lp = torch.log_softmax(batched_index_select(logits, actions_ixs).float(), dim=-1)
    cross_entropy = -_taken(lp, actions)
    awac_weight = torch.exp(beta * (target_q - V)).detach()
    terms = dict(q_sum=q_sum, v_sum=v_sum, cql_sum=sum(cql_sum(q) for q in qs),
                 awac_sum=(cross_entropy * awac_weight * terminal_mask).sum())
    return terms, dict(V=V, Q=Q, terminal_mask=terminal_mask)


def ilql_loss(
    logits: torch.Tensor,
    qs: Sequence[torch.Tensor],
    target_qs: Sequence[torch.Tensor],
    vs: torch.Tensor,
    input_ids: torch.Tensor,
    actions_ixs: torch.Tensor,
    dones: torch.Tensor,
    rewards: torch.Tensor,
    tau: float,
    gamma: float,
    cql_scale: float,
    awac_scale: float,
    beta: float = 0.0,
) -> Tuple[torch.Tensor, Dict]:
    """The ILQL objective (shapes as `ilql_loss_terms`; the heads were
    index-selected by the model): each term's sum over the nonterminal
    actions' count. Returns (loss, stats) with `losses/{loss, loss_q,
    loss_v, loss_cql, loss_awac}`, `values/*` and `qvalues/<i>/*`."""
    terms, aux = ilql_loss_terms(logits, qs, target_qs, vs, input_ids, actions_ixs, dones, rewards,
                                 tau=tau, gamma=gamma, beta=beta)
    terminal_mask = aux["terminal_mask"]
    n_nonterminal = torch.clamp(terminal_mask.sum(), min=1.0)
    loss_q = terms["q_sum"] / n_nonterminal
    loss_v = terms["v_sum"] / n_nonterminal
    loss_cql = terms["cql_sum"] / n_nonterminal
    loss_awac = terms["awac_sum"] / n_nonterminal
    loss = loss_q + loss_v + cql_scale * loss_cql + awac_scale * loss_awac
    stats = dict(
        losses=dict(loss=loss, loss_q=loss_q, loss_v=loss_v, loss_cql=loss_cql, loss_awac=loss_awac),
        values=get_tensor_stats(aux["V"], terminal_mask, n_nonterminal),
        qvalues={str(i): get_tensor_stats(q, terminal_mask, n_nonterminal) for i, q in enumerate(aux["Q"])},
    )
    return loss, stats
