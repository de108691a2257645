"""The benchmark's input generators, made on the device from ``--seed``."""

_M64 = (1 << 64) - 1


def _mixed(seed: int) -> int:
    """``seed`` as 63 bits in which every bit of it counts: splitmix64's
    finalizer, since the CPU's generator keeps only a seed's low 32."""
    z = int(seed) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


def generator(torch, seed: int, device):
    """A ``torch.Generator`` on ``device`` seeded from any whole number,
    negative and large ones too."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_mixed(seed))
    return gen
