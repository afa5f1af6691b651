"""Helpers of the language-model tests of the port: the JAX package's
parameter tree carried to the test process as one ``.npz`` file.

``SAVE_PARAMS`` goes into a reference child process's snippet (it holds no
braces, so a snippet that is ``str.format``-ed may include it as it is)
and defines ``save_params(params, path)``: every leaf under its
``/``-joined path.  :func:`unflatten` turns the loaded file back into the
nested tree that ``repro_torch.convert.params_from_reference`` takes.
"""

from __future__ import annotations

SAVE_PARAMS = """
def save_params(params, path):
    flat = dict()
    def walk(t, keys):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, keys + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, keys + (str(i),))
        else:
            flat["/".join(keys)] = np.asarray(t)
    walk(params, ())
    np.savez(path, **flat)
"""


def unflatten(flat) -> dict:
    """``{"stacks/0/layers/0/mixer/wq": a, ...}`` -> the nested tree (dicts,
    and lists where every key of a level is a digit)."""
    tree: dict = {}
    for key in flat.files:
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]

    def lists(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}

    return lists(tree)
