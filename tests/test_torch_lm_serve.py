"""The port's LM serving launcher (`repro_torch/launch/serve.py`) on the
CPU for seven archs (the dense family's front ends, mixtral, mamba2, jamba
and deepseek-v3), its default arch (JAX's, mixtral-8x7b), and the
feature-selection flow of `examples/feature_selection_lm.py`
(a frozen LM's last-position hidden states as the design matrix of a
sparse Elastic Net fit, p = d_model > n) at SMOKE width: the port's hidden
states within 1e-4 x max|h| of JAX's on JAX's weights, and the port's
`sven` on JAX's X selecting JAX's support, with beta within 1e-8 x
max|beta|; then the port's own flow (its generator's draws) solved by
`sven` on the primal branch within 5e-4 x max|beta_cd| of coordinate
descent."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import elastic_net_cd as j_cd
from repro.configs import get_config as j_get_config
from repro.core import sven as j_sven
from repro.core.elastic_net import lambda1_max as j_lambda1_max
from repro.models import model as JM
from repro_torch.baselines import elastic_net_cd
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.core import sven
from repro_torch.core.elastic_net import lambda1_max
from repro_torch.launch import serve as launcher
from repro_torch.models import model as M

N_SEQ, SEQ, LAMBDA2 = 48, 32, 0.5


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "musicgen-large", "internvl2-26b",
                                  "mixtral-8x7b", "mamba2-130m", "jamba-v0.1-52b",
                                  "deepseek-v3-671b"])
def test_launcher_runs_on_the_cpu(arch, capsys):
    argv = ["--arch", arch, "--batch", "2", "--prompt-len", "8", "--gen", "3",
            "--device", "cpu"]
    assert launcher.run(argv) > 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[serve] ") and "prefill 2x8 in" in line and "decode 6 tokens" in line
    res = launcher.serve(argv)
    cfg = get_config(arch, smoke=True)
    tail = (cfg.n_codebooks,) if cfg.frontend == "codebooks" else ()
    assert res.tokens.shape == (2, 4) + tail and res.n_decoded == 6
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab_size
    # the same seeds give the same tokens
    assert torch.equal(launcher.serve(argv).tokens, res.tokens)


def test_launcher_default_arch_is_jax_s():
    assert launcher._parser().parse_args([]).arch == "mixtral-8x7b"


def test_launcher_smoke_flag():
    ap = launcher._parser()
    assert ap.parse_args([]).smoke is True
    assert ap.parse_args(["--no-smoke"]).smoke is False
    assert ap.parse_args(["--smoke"]).smoke is True


@pytest.fixture(scope="module")
def jax_flow():
    """JAX's example flow at SMOKE width: weights, tokens, X, y, t and its
    CD and `sven` solutions."""
    cfg = j_get_config("internlm2-1.8b", smoke=True)
    params = JM.init_model(jax.random.PRNGKey(0), cfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (N_SEQ, SEQ), 0, cfg.vocab_size)
    _, _, h = JM.forward(params, cfg, {"tokens": toks}, return_hidden=True)
    X = jnp.asarray(h[:, -1, :], jnp.float64)
    X = (X - X.mean(0)) / (X.std(0) + 1e-9)
    key = jax.random.PRNGKey(2)
    true_idx = jax.random.choice(key, cfg.d_model, (5,), replace=False)
    w = jax.random.normal(jax.random.fold_in(key, 1), (5,))
    y = X[:, true_idx] @ w + 0.05 * jax.random.normal(jax.random.fold_in(key, 2), (N_SEQ,))
    y = y - y.mean()
    l1 = 0.25 * float(j_lambda1_max(X, y))
    beta_cd = j_cd(X, y, l1, LAMBDA2).beta
    t = float(jnp.sum(jnp.abs(beta_cd)))
    sol = j_sven(X, y, t, LAMBDA2)
    return dict(params=jax.tree.map(np.asarray, params), toks=np.asarray(toks),
                h=np.asarray(h), X=np.asarray(X), y=np.asarray(y), l1=l1, t=t,
                beta_cd=np.asarray(beta_cd), beta=np.asarray(sol.beta))


def test_hidden_states_match_jax(jax_flow):
    cfg = get_config("internlm2-1.8b", smoke=True)
    params = model_params_from_jax(jax_flow["params"], cfg, device="cpu")
    _, _, h = M.forward(params, cfg, {"tokens": torch.tensor(jax_flow["toks"])},
                        return_hidden=True)
    dev = np.abs(h.numpy() - jax_flow["h"]).max()
    assert dev <= 1e-4 * np.abs(jax_flow["h"]).max()


def test_sven_on_jax_hidden_states_selects_jax_support(jax_flow):
    X = torch.tensor(jax_flow["X"])
    y = torch.tensor(jax_flow["y"])
    cd = elastic_net_cd(X, y, jax_flow["l1"], LAMBDA2)
    assert np.abs(cd.beta.numpy() - jax_flow["beta_cd"]).max() <= \
        1e-8 * np.abs(jax_flow["beta_cd"]).max()
    sol = sven(X, y, jax_flow["t"], LAMBDA2)
    assert sol.mode == "primal"
    want = jax_flow["beta"]
    assert np.abs(sol.beta.numpy() - want).max() <= 1e-8 * np.abs(want).max()
    support = np.flatnonzero(np.abs(sol.beta.numpy()) > 1e-6)
    assert support.size > 0 and np.array_equal(support, np.flatnonzero(np.abs(want) > 1e-6))


def test_port_flow_solves_primal_near_cd():
    """The flow as the card runs it, drawn from the port's generators."""
    cfg = get_config("internlm2-1.8b", smoke=True)
    dev = torch.device("cpu")
    params = M.init_model(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    gen = torch.Generator(dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (N_SEQ, SEQ), generator=gen)
    with torch.inference_mode():
        _, _, h = M.forward(params, cfg, {"tokens": toks}, return_hidden=True)
    X = h[:, -1, :].to(torch.float64)
    X = (X - X.mean(0)) / (X.std(0, correction=0) + 1e-9)
    true_idx = torch.randperm(cfg.d_model, generator=gen)[:5]
    w = torch.randn(5, generator=gen, dtype=torch.float64)
    y = X[:, true_idx] @ w + 0.05 * torch.randn(N_SEQ, generator=gen, dtype=torch.float64)
    y = y - y.mean()
    beta_cd = elastic_net_cd(X, y, 0.25 * float(lambda1_max(X, y)), LAMBDA2).beta
    sol = sven(X, y, float(beta_cd.abs().sum()), LAMBDA2)
    assert sol.mode == "primal"
    assert (sol.beta - beta_cd).abs().max() <= 5e-4 * beta_cd.abs().max()
