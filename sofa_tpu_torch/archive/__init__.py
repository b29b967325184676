"""The multi-run trace archive, a content-addressed store of many runs
(the JAX package's ``sofa_tpu/archive/``, with the fleet service and its
tier).

One logdir answers "what happened in this run"; the archive answers "did
this run regress against the last hundred".  It is built from what the
pipeline already has: the logdir's sha256 digests are the dedup index,
the content-keyed tile pyramid and frame chunks make two runs compare by
hash, and the journal's fsync discipline makes every write crash-safe.

An archive root (``--archive_root``, else ``SOFA_ARCHIVE_ROOT``, else
``./sofa_archive/``)::

    sofa_archive.json      marker: schema and version (is_archive_root)
    catalog.jsonl          append-only event ledger (fsync'd lines:
                           ingest, bench, gc; a torn tail is skipped)
    objects/<aa>/<sha256>  content blobs (frames, frame chunks, tiles,
                           the normalized manifest, raw captures), one
                           copy however many runs share the bytes
    runs/<run_id>.json     a run's doc: rel path -> sha256, the feature
                           vector, provenance
    _index/                the columnar catalog index (index.py)

``run_id`` is the sha256 of the run's (path, sha256) map: re-ingesting an
unchanged logdir gives the same id and grows the store by one catalog
line.  The schema strings are the JAX package's, so that each package
reads the other's roots.

Verbs: ``archive <logdir>`` ingests (and ``ls``, ``show <run>``, ``gc
--keep N --keep_days D``, ``fsck``, ``backup``, ``restore``); ``regress
<run> [<baseline>]`` (verdict.py) is the typed regression engine over the
catalog; ``fsck <archive_root>`` checks the store.  ``serve <root>``
(service.py, over the write-ahead queue of tier.py) takes runs that
``agent`` (client.py, spool.py) pushes into tenant archive roots under
``<root>/tenants/``; protocol.py holds their shared vocabulary.
"""

from __future__ import annotations

import os

ARCHIVE_MARKER_NAME = "sofa_archive.json"
CATALOG_NAME = "catalog.jsonl"
OBJECTS_DIR_NAME = "objects"
RUNS_DIR_NAME = "runs"
QUARANTINE_DIR_NAME = "_quarantine"
VERDICT_NAME = "regress_verdict.json"

ARCHIVE_SCHEMA = "sofa_tpu/archive"
# Bumps on a breaking change of layout or meaning; added keys do not.
ARCHIVE_VERSION = 1

DEFAULT_ROOT = "sofa_archive"


def resolve_root(cfg=None) -> str:
    """The archive root: ``--archive_root``, else ``SOFA_ARCHIVE_ROOT``,
    else ``./sofa_archive``."""
    root = getattr(cfg, "archive_root", "") if cfg is not None else ""
    return root or os.environ.get("SOFA_ARCHIVE_ROOT", "") or DEFAULT_ROOT


def is_archive_root(path: str) -> bool:
    """Whether ``path`` is an archive root (its marker exists): what
    ``clean``, the digests and ``fsck`` dispatch on, so that an archive
    nested in a logdir is never swept as derived output."""
    return os.path.isfile(os.path.join(path, ARCHIVE_MARKER_NAME))
