"""SS2D's forms in the port (smow_net_tpu_torch/nn/ssm.py) against the JAX
package's SS2D on CPU, at width 8 on a (3, 5) map, with no whole-model JAX
compile: K = 8, scan_variant 1d and 2d, d_state 4, and the xv forms with
each postfix (and the constructor's other options spread over the cases),
fp32 on both sides with the real scans (the port's plain version, JAX's
associative scan). The output is held to 1e-5 of its largest element, the
input's and every parameter's gradient to 1e-4 of the leaf's largest.

The layer family's other parts (the traversals, VSSBlock, VSSM, remat) are
in tests/test_torch_ss2d_family.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.nn import ssm as jssm
from smow_net_tpu_torch.nn.ssm import SS2D
from test_torch_change_mamba import _seeded
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)
from test_torch_ss2d_family import H, W, _port_sd, run_compiled


# each case: the JAX SS2D's keyword arguments; every xv mode, postfix and
# out-norm appears, and the constructor's other options are spread over the
# v2 cases
SS2D_CASES = {
    "k8": dict(k_group=8),
    "1d_dstate4_noconv_bias": dict(scan_variant="1d", d_state=4, d_conv=1, bias=True),
    "2d_rank3_nobias_conv": dict(scan_variant="2d", dt_rank=3, conv_bias=False, ssm_ratio=1.5),
    "xv2a": dict(forward_type="xv2a"),
    "xv1aactnone": dict(forward_type="xv1aactnone"),
    "xv2amuldwconv3": dict(forward_type="xv2amuldwconv3"),
    "xv3asoftmax": dict(forward_type="xv3asoftmax", d_state=4),
    "xv1asigmoidno32": dict(forward_type="xv1asigmoidno32"),
}


@pytest.mark.parametrize("case", list(SS2D_CASES))
def test_ss2d_matches_jax(case):
    """Forward, the input's gradient and every parameter's gradient, fp32,
    at width 8 on a (3, 5) map."""
    kw = SS2D_CASES[case]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, H, W, 8)).astype(np.float32)
    jmod = jssm.SS2D(8, **kw)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = _seeded(shapes["params"], rng)
    gy = rng.normal(size=x.shape).astype(np.float32)

    def run(p, v, g):
        out, vjp = jax.vjp(lambda p, v: jmod.apply({"params": p}, v), p, v)
        return out, vjp(g)

    want, (gp, gx) = run_compiled(run, params, jnp.asarray(x), jnp.asarray(gy))
    want = np.asarray(want)

    port = SS2D(8, **kw)
    port.load_state_dict(_port_sd(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt)
    assert np.abs(got.detach().numpy() - want).max() <= 1e-5 * np.abs(want).max()
    got.backward(torch.from_numpy(gy))
    assert np.abs(xt.grad.numpy() - np.asarray(gx)).max() <= 1e-4 * np.abs(gx).max()
    wgrads = _port_sd(jax.tree_util.tree_map(np.asarray, gp))
    assert set(wgrads) == {n for n, _ in port.named_parameters()}
    for n, p in port.named_parameters():
        w = wgrads[n].numpy()
        assert np.abs(p.grad.numpy() - w).max() <= 1e-4 * np.abs(w).max(), n
