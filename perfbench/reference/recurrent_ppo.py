"""Plain reference of the upstream navigation training recipe's learner:
rl-games' recurrent PPO with a shared MLP, a GRU core, a LayerNorm on the
core's output and separate mean and value heads, as the reference
framework's ``rl_training/rl_games/ppo_aerial_quad_navigation.yaml`` sets
it up.

Float32 throughout, with TF32 off (``no_tf32``); every piece is written
out: the network (elu MLP, the GRU's equations, the LayerNorm, the heads),
the Gaussian log-probability, the truncation bootstrap and GAE, the
running moments of the observations and of the values, the advantages
normalised over the global minibatch, the clipped policy and value losses
with the bounds loss, the clip by the global gradient norm, Adam (eps 1e-5)
and the adaptive learning rate. Gradients come from ``torch.autograd``.
Parameters are a dict under the names of the trainer's state dict
(``encoder.<i>.weight`` (out, in), ``gru.ir`` / ``iz`` / ``in_`` / ``hr`` /
``hz`` / ``hn``, ``rnn_norm``, ``mean_head``, ``value_head``, ``log_std``).
Imports nothing of the port.

``quant`` selects the control's arithmetic: None is float32; "bf16" rounds
every product's operands to bfloat16 (``networks.round_operand``).

Departures from rl-games, each kept because the program under test makes
it and noted here:

- the GRU keeps flax's gate layout: ``torch.nn.GRU`` also adds a
  hidden-side bias to the reset and update gates (zero at the start);
- the advantages are normalised over each global minibatch (all ranks'
  rows of it), where rl-games normalises each rank's whole rollout once;
- the observation moments are folded once an update, from the rollout's
  normalised observations over every rank, where rl-games folds each
  minibatch's raw observations in the model's forward pass;
- the value moments are folded from every rank's values and returns
  (rl-games folds each rank's own);
- the rollout's hidden state is replayed from its start in every
  minibatch, zeroed after each episode end (rl-games replays from the
  states it stored every ``seq_length`` steps: the same here, as the
  sequence is the whole horizon).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .networks import round_operand

LAYER_NORM_EPS = 1e-5
ADAM_EPS = 1e-5
ADAM_BETAS = (0.9, 0.999)
NORM_EPS = 1e-8
OBS_CLIP = 5.0
BOUND = 1.1


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _dense(p, name, x, quant):
    """x (..., in) through a torch-layout layer (weight (out, in))."""
    w = p[f"{name}.weight"]
    y = round_operand(x, quant) @ round_operand(w, quant).t()
    b = p.get(f"{name}.bias")
    return y if b is None else y + b


def policy_forward(p, obs, h, quant=None):
    """-> (action mean, log_std, value, new hidden) of normalised
    observations ``obs`` (N, D) and the hidden state ``h`` (N, H) the step
    starts from (already zeroed after an episode end)."""
    x = obs
    i = 0
    while f"encoder.{i}.weight" in p:
        x = F.elu(_dense(p, f"encoder.{i}", x, quant))
        i += 1
    r = torch.sigmoid(_dense(p, "gru.ir", x, quant) + _dense(p, "gru.hr", h, quant))
    z = torch.sigmoid(_dense(p, "gru.iz", x, quant) + _dense(p, "gru.hz", h, quant))
    n = torch.tanh(_dense(p, "gru.in_", x, quant) + r * _dense(p, "gru.hn", h, quant))
    h_new = (1.0 - z) * n + z * h
    y = h_new
    if "rnn_norm.weight" in p:
        mu = y.mean(dim=-1, keepdim=True)
        var = (y - mu).pow(2).mean(dim=-1, keepdim=True)
        y = (y - mu) / torch.sqrt(var + LAYER_NORM_EPS) * p["rnn_norm.weight"] + p["rnn_norm.bias"]
    mean = _dense(p, "mean_head", y, quant)
    value = _dense(p, "value_head", y, quant)[..., 0]
    return mean, p["log_std"], value, h_new


def gaussian_logp(mean, log_std, action):
    z = (action - mean) / torch.exp(log_std)
    return (-0.5 * z * z - log_std - 0.5 * math.log(2.0 * math.pi)).sum(dim=-1)


# -- returns -------------------------------------------------------------------


def shaped_rewards(reward, value, trunc, scale, gamma):
    """The scaled reward with the truncation bootstrap: a step cut by the
    episode's time limit gets gamma V(s) added, so a timeout is no
    terminal."""
    return reward * scale + gamma * value * trunc


def gae(values, rewards, dones, last_value, gamma, lam):
    """GAE(lambda) over a time-major (T, N) rollout -> (advantages, returns)."""
    T = values.shape[0]
    adv = torch.zeros_like(values)
    running = torch.zeros_like(last_value)
    for t in reversed(range(T)):
        v_next = last_value if t == T - 1 else values[t + 1]
        delta = rewards[t] + gamma * v_next * (1.0 - dones[t]) - values[t]
        running = delta + gamma * lam * (1.0 - dones[t]) * running
        adv[t] = running
    return adv, adv + values


# -- running moments -----------------------------------------------------------


def fold_moments(mean, var, count, batch):
    """Running moments (over dim 0 of ``batch``) after folding in a batch:
    the parallel combination of two sets' means and variances."""
    b_mean = batch.mean(dim=0)
    b_var = (batch - b_mean).pow(2).mean(dim=0)
    b_count = float(batch.shape[0])
    tot = count + b_count
    delta = b_mean - mean
    m2 = var * count + b_var * b_count + delta * delta * count * b_count / tot
    return mean + delta * b_count / tot, m2 / tot, tot


def normalize_obs(x, mean, var):
    return torch.clamp((x - mean) / torch.sqrt(var + NORM_EPS), -OBS_CLIP, OBS_CLIP)


def normalize_value(v, mean, var):
    return (v - mean) / torch.sqrt(var + NORM_EPS)


def unnormalize_value(v, mean, var):
    return v * torch.sqrt(var + NORM_EPS) + mean


def value_targets(values, returns, v_mean, v_var, v_count):
    """rl-games' value normalisation in the update: fold the values, then
    normalise them; fold the returns, then normalise them -> (normalised
    values, normalised returns, the moments after)."""
    m, v, c = fold_moments(v_mean, v_var, v_count, values.reshape(-1, 1))
    values_st = normalize_value(values, m[0], v[0])
    m, v, c = fold_moments(m[0], v[0], c, returns.reshape(-1, 1))
    return values_st, normalize_value(returns, m[0], v[0]), (m[0], v[0], c)


# -- one optimizer step --------------------------------------------------------


def ppo_loss(p, cfg, mb, h0, quant=None):
    """The clipped PPO loss of a minibatch of whole sequences -> (total,
    approximate KL). ``mb``: (E, T, ...) fields ``obs``, ``action``,
    ``old_logp``, ``old_value``, ``adv`` (not yet normalised), ``ret``,
    ``done_prev``; ``h0`` (E, H) the rollout-start hidden states."""
    adv = mb["adv"]
    adv = (adv - adv.mean()) / (torch.sqrt((adv - adv.mean()).pow(2).mean()) + NORM_EPS)
    h, means, values = h0, [], []
    for t in range(mb["obs"].shape[1]):
        h = h * (1.0 - mb["done_prev"][:, t])[:, None]
        mean, log_std, value, h = policy_forward(p, mb["obs"][:, t], h, quant)
        means.append(mean)
        values.append(value)
    mean, value = torch.stack(means, dim=1), torch.stack(values, dim=1)
    logp = gaussian_logp(mean, log_std, mb["action"])
    d = logp - mb["old_logp"]
    ratio = torch.exp(d)
    clip = cfg["e_clip"]
    pg = torch.maximum(-adv * ratio, -adv * torch.clamp(ratio, 1.0 - clip, 1.0 + clip)).mean()
    old = mb["old_value"]
    v_clipped = old + torch.clamp(value - old, -clip, clip)
    v_loss = 0.5 * torch.maximum((value - mb["ret"]) ** 2, (v_clipped - mb["ret"]) ** 2).mean()
    entropy = (log_std + 0.5 * math.log(2.0 * math.pi * math.e)).sum()
    bounds = (torch.clamp(mean - BOUND, min=0.0) ** 2
              + torch.clamp(mean + BOUND, max=0.0) ** 2).sum(dim=-1).mean()
    total = (pg + cfg["critic_coef"] * v_loss - cfg["entropy_coef"] * entropy
             + cfg["bounds_loss_coef"] * bounds)
    return total, (ratio - 1.0 - d).mean().detach()


def clip_by_global_norm(grads, max_norm):
    norm = torch.sqrt(sum(g.pow(2).sum() for g in grads))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [g * scale for g in grads]


def adam(params, grads, state, lr):
    """One Adam step, written out -> (parameters, state). ``state``: per
    name ``step``, ``exp_avg``, ``exp_avg_sq``."""
    b1, b2 = ADAM_BETAS
    new_p, new_s = {}, {}
    for k, g in grads.items():
        s = state[k]
        step = s["step"] + 1
        m = s["exp_avg"] * b1 + g * (1.0 - b1)
        v = s["exp_avg_sq"] * b2 + g * g * (1.0 - b2)
        bias1 = 1.0 - b1 ** step
        bias2 = 1.0 - b2 ** step
        denom = torch.sqrt(v) / math.sqrt(bias2) + ADAM_EPS
        new_p[k] = params[k] - (lr / bias1) * m / denom
        new_s[k] = dict(step=step, exp_avg=m, exp_avg_sq=v)
    return new_p, new_s


def adapt_lr(cfg, lr, kl):
    """rl-games' adaptive schedule: lr / 1.5 above twice the KL threshold,
    x 1.5 below half of it, within [min_lr, max_lr]."""
    thr = cfg["kl_threshold"]
    if kl > 2.0 * thr:
        return max(lr / 1.5, cfg["min_lr"])
    if kl < 0.5 * thr:
        return min(lr * 1.5, cfg["max_lr"])
    return lr


def optimizer_step(params, state, lr, cfg, mb, h0, quant=None):
    """One step on one global minibatch -> (parameters, Adam state, next
    lr). ``params`` and ``state`` are not changed; ``state[name]["step"]``
    is a Python number."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    total, kl = ppo_loss(leaves, cfg, mb, h0, quant)
    names = list(leaves)
    grads = torch.autograd.grad(total, [leaves[k] for k in names], allow_unused=True)
    grads = [torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(names, grads)]
    grads = dict(zip(names, clip_by_global_norm(grads, cfg["grad_norm"])))
    new_p, new_s = adam({k: v.detach() for k, v in params.items()}, grads, state, lr)
    return new_p, new_s, adapt_lr(cfg, lr, float(kl))


def split_rows(rows, obs_dim, action_dim):
    """The trainer's per-env rows (E, T, obs | action | old logp | old value
    | advantage | return | done_prev) -> the minibatch fields."""
    o, a = obs_dim, obs_dim + action_dim
    return dict(obs=rows[..., :o], action=rows[..., o:a], old_logp=rows[..., a],
                old_value=rows[..., a + 1], adv=rows[..., a + 2], ret=rows[..., a + 3],
                done_prev=rows[..., a + 4])


def update_rows(params, norm, ro, last, cfg, quant=None):
    """What the update computes before its epochs, on the rollout of every
    env -> (rows (N, T, fields) in ``split_rows``' layout, advantages (T, N),
    normalised returns (T, N)). ``norm``: the moments before the update
    (``mean``, ``var``, ``count`` of the observations, ``v_mean``,
    ``v_var``, ``v_count`` of the values); ``ro``: time-major (T, N)
    ``norm_obs``, ``actions``, ``logps``, ``values``, ``rewards``,
    ``dones``, ``done_prev``, envs in order; ``last``: the observation
    after the rollout (``obs``), the hidden state and the episode-end mask
    after it (``h``, ``done``). The observation moments are folded first
    and the last value is read with them."""
    T, N = ro["values"].shape
    mean, var, _ = fold_moments(norm["mean"], norm["var"], norm["count"],
                                ro["norm_obs"].reshape(T * N, -1))
    h = last["h"] * (1.0 - last["done"])[:, None]
    last_value = policy_forward(params, normalize_obs(last["obs"], mean, var), h, quant)[2]
    last_value = unnormalize_value(last_value, norm["v_mean"], norm["v_var"])
    adv, ret = gae(ro["values"], ro["rewards"], ro["dones"], last_value, cfg["gamma"],
                   cfg["tau"])
    values_st, ret_st, _ = value_targets(ro["values"], ret, norm["v_mean"], norm["v_var"],
                                         norm["v_count"])
    col = lambda x: x[..., None]
    rows = torch.cat([ro["norm_obs"], ro["actions"], col(ro["logps"]), col(values_st), col(adv),
                      col(ret_st), col(ro["done_prev"])], dim=-1).transpose(0, 1)
    return rows, adv, ret_st


def update(params, state, lr, cfg, rows, h0, perms, minibatch_envs, quant=None):
    """The update's epochs: for each epoch's permutation of the env
    sequences, one optimizer step per minibatch of ``minibatch_envs``
    sequences -> (parameters, Adam state, lr)."""
    for perm in perms:
        for i in range(len(perm) // minibatch_envs):
            idx = perm[i * minibatch_envs:(i + 1) * minibatch_envs]
            mb = split_rows(rows[idx], cfg["obs_dim"], cfg["action_dim"])
            params, state, lr = optimizer_step(params, state, lr, cfg, mb, h0[idx], quant)
    return params, state, lr
