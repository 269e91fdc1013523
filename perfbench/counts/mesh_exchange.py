"""The exchange of a tile x spp mesh of cards (parallel/sharding.py: a
tile group's members copy each other's tensors card to card)
rendering VCM with its photons gathered over the tile axis: the bytes it
moves in a window, from quantities the settings fix.

A call renders one sample on each rank, n_spp samples of the frame; a
dispatch of k samples is k / n_spp calls. In a call each rank receives
the posts of the (n_tile - 1) other members of its tile group:
  - the photon all-gather: the photon rows of their light paths, one row
    a stored light vertex (the light depth's rows a path: the walk's
    [max_depth - 1, N] buffers at max_depth = light depth + 1), each 32
    bytes and a validity byte;
  - the splat's all-reduce: their full-frame splat, 12 bytes a pixel;
and every rank but the first hands the first card its tile's radiance
(12 bytes a pixel) and its counts of rays and dropped photons (two int64),
which the first card sums over the spp axis. Every one of these moves as
a peer copy ("Memcpy PtoP" in the device trace). No operation is counted.
"""

KERNELS = ("PtoP",)
ROW_BYTES = 8 * 4 + 1   # a packed photon row and its validity byte
PIXEL_BYTES = 3 * 4     # one float32 RGB
COUNT_BYTES = 2 * 8     # rays and dropped photons, int64


def mesh_shape(cfg: dict) -> tuple:
    """(n_tile, n_spp) of a configuration's `Mesh Shape`."""
    return tuple(int(n) for n in cfg["rendertron"]["Mesh Shape"].split())


def call_bytes(pixels: int, light_depth: int, n_tile: int,
               n_spp: int) -> int:
    """The bytes one call moves, summed over the ranks."""
    ranks = n_tile * n_spp
    n_local = pixels // n_tile
    photons = (n_tile - 1) * light_depth * n_local * ROW_BYTES
    splat = (n_tile - 1) * pixels * PIXEL_BYTES
    to_first = n_local * PIXEL_BYTES + COUNT_BYTES
    return ranks * (photons + splat) + (ranks - 1) * to_first


def work(q: dict, cfg: dict) -> tuple:
    """q: the window's dispatches, and the frame's pixels and a dispatch's
    samples k (the reader adds them)."""
    shape = mesh_shape(cfg)
    depth = int(cfg["rendertron"]["Bidirectional Light Depth"])
    calls = q["dispatches"] * q["k"] // shape[1]
    return calls * call_bytes(q["pixels"], depth, *shape), 0
