"""The one generator of every traffic mix.

A mix (``traffic/<mix>.json``) names the program's entry its calls go
through (``solve_batch``: one call solves a batch of ``batch`` instances;
``solve``: one call solves one instance), how many distinct calls the
pool holds (``pool``), the sizes it adds to the configuration's
(``sizes``), and the solver settings the calls ask for (``solver``).  The
pool is drawn on the device from the seed, in the configuration's dtype,
with the family's sampler (``traffic/<family>.py``); the window sends its
calls in turn, the next once the last has returned (a closed loop of one
client).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from portbench import registry

ENTRIES = ("solve_batch", "solve")


@dataclass
class Call:
    x0: torch.Tensor       # (batch, D), or (D,) for ``solve``
    params: tuple          # the family's NamedTuple, batched or one row


def sizes_of(config: dict, mix: dict) -> dict:
    return {**config.get("sizes", {}), **mix.get("sizes", {})}


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def pool(config: dict, mix: dict, seed: int, device, dtype,
         root=registry.ROOT) -> list:
    """The mix's pool of calls for ``seed``: the same seed gives the same
    calls on the same device.  The family's sampler and start come from
    the benchmark at ``root``."""
    entry = mix["entry"]
    if entry not in ENTRIES:
        raise ValueError(f"unknown entry {entry!r}")
    fam = config["family"]
    sample = registry.sampler(fam, root).sample
    start = registry.family_math(fam, root).start
    sizes, consts = sizes_of(config, mix), config.get("constants", {})
    gen = generator(seed, device)
    n, batch = int(mix["pool"]), int(mix["batch"])
    if entry == "solve_batch":
        return [Call(start(batch, sizes, consts, dtype, device),
                     sample(gen, batch, sizes, consts, dtype, device))
                for _ in range(n)]
    if batch != 1:
        raise ValueError("a 'solve' mix has batch 1")
    data = sample(gen, n, sizes, consts, dtype, device)
    x0 = start(1, sizes, consts, dtype, device)[0]
    return [Call(x0, type(data)(*(t[i] for t in data))) for i in range(n)]
