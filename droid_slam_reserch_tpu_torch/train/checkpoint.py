"""Training checkpoints that both packages read.

A checkpoint is an ``.npz`` with the parameters under "params" as a pickled
dict of numpy arrays in the JAX package's tree layout, and "step"; so the
JAX package's ``load_ckpt`` and the port's ``load_weights`` (``--weights``)
read the parameters.  The port's AdamW state goes under keys that the JAX
package ignores: "adam_mu" and "adam_nu" (trees like "params") and
"adam_count"; so a resumed run continues exactly where it stopped.

A JAX checkpoint's optimizer state ("opt_state") is made of optax's
classes and cannot be read without optax: its parameters are a warm start.
"""
import numpy as np

from ..models.convert import params_from_jax, params_to_jax


def _obj(x):
    arr = np.empty((), dtype=object)
    arr[()] = x
    return arr


def save_ckpt(path, params, opt_state, step):
    """Write params, the optimizer state and the step to an npz."""
    np.savez(path, params=_obj(params_to_jax(params)), step=np.int64(step),
             adam_mu=_obj(params_to_jax(opt_state["mu"])),
             adam_nu=_obj(params_to_jax(opt_state["nu"])),
             adam_count=np.int64(opt_state["count"]))


def load_ckpt(path, device="cpu"):
    """Returns (params, opt_state | None, step), tensors on `device`.

    A checkpoint of the port resumes exactly; any other (a JAX checkpoint,
    or one of parameters only) gives its parameters, no optimizer state and
    step 0: a warm start, not a resume.
    """
    def tensors(tree):
        return {k: v.to(device) for k, v in params_from_jax(tree).items()}

    with np.load(path, allow_pickle=True) as data:
        params = tensors(data["params"].item())
        if "adam_count" not in data.files:
            if "opt_state" in data.files:
                print(f"{path}: the optax optimizer state of a JAX checkpoint cannot be read "
                      "without optax; its parameters are a warm start (step 0, fresh AdamW)")
            return params, None, 0
        opt_state = {"count": int(data["adam_count"]), "mu": tensors(data["adam_mu"].item()),
                     "nu": tensors(data["adam_nu"].item())}
        return params, opt_state, int(data["step"])


