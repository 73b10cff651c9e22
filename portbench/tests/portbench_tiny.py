"""The tiny size the CPU tests run the benchmark at."""

# a budget at which MobileNet-v1 0.25 @ 96 int8 needs Pex slices and ring
# cascades (its reorder-only arena is 55 296 B); planned in ~2 s on a CPU
TINY = dict(alpha=0.25, resolution=96, arena_budget_bytes=46000, lanes=4,
            calibration_images=8)


def tiny_cell(config: str, traffic: str = "backlog", **params):
    """A cell of ``config`` under the mix ``traffic`` (found by name, as
    the harness finds them) cut to the tiny size, with every metric of
    BENCHMARK.json that such a cell reports."""
    from portbench.harness import spec
    root = spec.ROOT
    cell = spec.Cell(
        f"{config}.{traffic}",
        {**spec._json(root / "configs" / f"{config}.json"), **TINY},
        {**spec._json(root / "traffic" / f"{traffic}.json"), "pool": 16,
         **params}, 1, [], [])
    for m in spec.metrics(spec.load_spec()):
        (cell.end_to_end if m.end_to_end else cell.per_layer).append(m)
    return cell
