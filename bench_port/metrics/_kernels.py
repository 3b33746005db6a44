"""Device time of the traced batches by kernel class (``kernel_classes.json``),
shared by the per-layer readers."""


def _match(name, patterns):
    return any(p in name for p in patterns)


def kernel_class(name, classes):
    """``memory``, ``port``, ``library`` or ``small`` for a kernel name."""
    for cls in ("memory", "port", "library"):
        if _match(name, classes[cls]):
            return cls
    return "small"


def device_us(rec, cls):
    """Summed device time [us] of the traced batches' kernels of ``cls``
    (a class name, or ``zoom`` for the zoom kernel's launches)."""
    classes = rec["classes"]
    if cls == "zoom":
        return sum(b - a for name, a, b in rec["kernels"]
                   if _match(name, classes["zoom"]))
    return sum(b - a for name, a, b in rec["kernels"]
               if kernel_class(name, classes) == cls)
