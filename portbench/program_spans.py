"""The program's own spans of a traced window, for the per-layer metrics
whose source is ``program_span``: ``stardis_tpu_torch.util.profiling
.spans()`` read once the window has closed (the program keeps the spans of
one profiler session, the window's).  A program without spans gives None."""


def mean_per_root(root, children):
    """Mean over the window's root spans named ``root`` of the summed walls
    of their direct children named in ``children``, ms; None where the
    program records no such root."""
    try:
        from stardis_tpu_torch.util.profiling import spans
    except ImportError:
        return None
    found = spans()
    roots = {s.id for s in found if s.name == root and s.parent is None}
    if not roots:
        return None
    walls = sum(s.end_ns - s.start_ns for s in found
                if s.parent in roots and s.name in children)
    return walls * 1e-6 / len(roots)
