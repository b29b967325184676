"""The fleet service's protocol vocabulary (the JAX package's
``sofa_tpu/archive/protocol.py``, whole).

The one place in this package that declares the HTTP surface between the
service (``archive/service.py``) and its client (``archive/client.py``):
the typed error bodies, the statuses each may ride, the Retry-After sets,
the client's dispatch sets and the route registry.  Both sides import
these names and repeat no literal.  The values are the JAX package's, so
each package's client speaks to the other's service.
"""

# ---------------------------------------------------------------------------
# Typed error-body vocabulary.  Every JSON refusal carries {"error": <one of
# these>}; clients dispatch on the string, never on prose.
# ---------------------------------------------------------------------------

ERR_NO_SUCH_ROUTE = "no_such_route"
ERR_UNAUTHORIZED = "unauthorized"
ERR_BAD_TENANT = "bad_tenant"
ERR_READ_ONLY_REPLICA = "read_only_replica"
ERR_MID_GC = "mid_gc"
ERR_DRAINING = "draining"
ERR_DEADLINE_EXPIRED = "deadline_expired"
ERR_BROWNOUT = "brownout"
ERR_WAL_BACKLOG = "wal_backlog"
ERR_BAD_KIND = "bad_kind"
ERR_BAD_PARAMS = "bad_params"
ERR_REPLICA_WARMING = "replica_warming"
ERR_NO_INDEX = "no_index"
ERR_NO_FLEET_REPORT = "no_fleet_report"
ERR_NO_SUCH_CHUNK = "no_such_chunk"
ERR_NO_SUCH_RUN = "no_such_run"
ERR_LENGTH_REQUIRED = "length_required"
ERR_TOO_LARGE = "too_large"
ERR_BAD_JSON = "bad_json"
ERR_BAD_FILES_MAP = "bad_files_map"
ERR_MISSING_OBJECTS = "missing_objects"
ERR_QUOTA = "quota"
ERR_HASH_MISMATCH = "hash_mismatch"
ERR_NO_SPACE = "no_space"
ERR_LOADED = "loaded"
ERR_NO_WORKER = "no_worker"

# ---------------------------------------------------------------------------
# Status -> permitted error bodies.  Keys are every status the protocol is
# allowed to emit; the tuple lists the typed error strings a refusal with
# that status may carry (empty tuple: status carries no error body).
# ---------------------------------------------------------------------------

STATUS_ERRORS = {
    200: (),
    204: (),
    304: (),
    400: (ERR_BAD_TENANT, ERR_BAD_KIND, ERR_BAD_PARAMS, ERR_BAD_JSON,
          ERR_BAD_FILES_MAP),
    401: (ERR_UNAUTHORIZED,),
    403: (ERR_READ_ONLY_REPLICA,),
    404: (ERR_NO_SUCH_ROUTE, ERR_NO_SUCH_RUN, ERR_NO_INDEX,
          ERR_NO_SUCH_CHUNK, ERR_NO_FLEET_REPORT),
    408: (),
    409: (ERR_MISSING_OBJECTS,),
    411: (ERR_LENGTH_REQUIRED,),
    413: (ERR_TOO_LARGE,),
    422: (ERR_HASH_MISMATCH,),
    425: (),
    429: (ERR_QUOTA,),
    502: (ERR_NO_WORKER,),
    503: (ERR_MID_GC, ERR_DRAINING, ERR_BROWNOUT, ERR_REPLICA_WARMING,
          ERR_LOADED, ERR_WAL_BACKLOG),
    504: (ERR_DEADLINE_EXPIRED,),
    507: (ERR_NO_SPACE,),
}

# ---------------------------------------------------------------------------
# Retry-After discipline.  Statuses in RETRY_AFTER_STATUSES are transient
# capacity refusals and MUST attach a Retry-After header; a deadline 504
# means the caller's budget is gone, so it must NOT invite a retry.
# ---------------------------------------------------------------------------

RETRY_AFTER_STATUSES = (429, 503, 507)
NO_RETRY_AFTER_STATUSES = (504,)

# ---------------------------------------------------------------------------
# Client dispatch sets.  client._attempt classifies by status: fatal ->
# ServiceRejected, resume -> ServiceIncomplete, retry (or >= floor) ->
# ServiceUnavailable.  FATAL_ERRORS lists typed error bodies that override
# a retryable status to fatal (e.g. a 429 quota breach never clears on its
# own, even though 429 otherwise invites retry).
# ---------------------------------------------------------------------------

CLIENT_FATAL_STATUSES = (401, 403)
CLIENT_RESUME_STATUSES = (409,)
CLIENT_RETRY_STATUSES = (408, 422, 425, 429)
CLIENT_RETRY_FLOOR = 500
FATAL_ERRORS = (ERR_QUOTA,)

# ---------------------------------------------------------------------------
# Route registry.  "<name>" segments are placeholders; clients and the
# board must only speak routes whose shape appears here, and every
# concrete segment must be dispatched by a handler.
# ---------------------------------------------------------------------------

ROUTES = (
    "GET /v1/ping",
    "GET /v1/health",
    "GET /v1/tier",
    "GET /v1/metrics",
    "GET /v1/<tenant>/catalog",
    "GET /v1/<tenant>/query",
    "GET /v1/<tenant>/fleet",
    "GET /v1/<tenant>/index/commit",
    "GET /v1/<tenant>/index/<family>/<chunk>",
    "GET /v1/<tenant>/run/<run_id>",
    "POST /v1/<tenant>/have",
    "POST /v1/<tenant>/commit",
    "PUT /v1/<tenant>/object/<sha256>",
    "OPTIONS /v1/<any>",
)
