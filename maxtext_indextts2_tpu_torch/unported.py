"""The one error for a feature of the JAX package that the port does not have
yet: it names the feature and the ROADMAP.md port-queue item that brings it."""


def _unsupported(what: str, roadmap_item: str):
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch/CUDA package yet "
        f"(ROADMAP.md, port queue: {roadmap_item})"
    )
