"""User/role auth: BasicAuth + per-endpoint privilege checks.

Mirrors the reference's auth model (reference: entity/user.go — Privilege
None/WriteOnly/ReadOnly/WriteRead, Resource map, ParseResources
entity/user.go:194-260, Role.HasPermissionForResources entity/user.go:300;
root bootstrap master/server.go:160-181; BasicAuth middleware
cluster_api.go:153 and router doc_http.go:122). Users carry a role; roles
grant a privilege per resource; every authenticated request is checked
against the (resource, privilege) derived from its endpoint + method.
"""

from __future__ import annotations

import base64
import hashlib
import secrets

from vearch_tpu_torch.cluster.rpc import RpcError

ROOT_NAME = "root"

# privilege lattice (reference: entity/user.go:29-34)
PRIVI_NONE = "None"
PRIVI_WRITE = "WriteOnly"
PRIVI_READ = "ReadOnly"
PRIVI_ALL = "WriteRead"

RESOURCE_ALL = "ResourceAll"
RESOURCE_CLUSTER = "ResourceCluster"
RESOURCE_SERVER = "ResourceServer"
RESOURCE_PARTITION = "ResourcePartition"
RESOURCE_DB = "ResourceDB"
RESOURCE_SPACE = "ResourceSpace"
RESOURCE_DOCUMENT = "ResourceDocument"
RESOURCE_INDEX = "ResourceIndex"
RESOURCE_ALIAS = "ResourceAlias"
RESOURCE_USER = "ResourceUser"
RESOURCE_ROLE = "ResourceRole"
RESOURCE_CONFIG = "ResourceConfig"

# builtin roles (reference: entity/user.go RoleMap — root/ClusterAdmin/
# SpaceAdmin/DocumentAdmin...; the short "read"/"write"/"document" names
# are kept for the SDK surface, with reference-faithful grants: "write"
# carries WriteOnly, not admin)
BUILTIN_ROLES = {
    "root": {RESOURCE_ALL: PRIVI_ALL},
    "read": {RESOURCE_ALL: PRIVI_READ},
    "write": {RESOURCE_ALL: PRIVI_WRITE},
    "document": {RESOURCE_DOCUMENT: PRIVI_ALL, RESOURCE_INDEX: PRIVI_ALL},
    "defaultClusterAdmin": {
        RESOURCE_CLUSTER: PRIVI_ALL, RESOURCE_SERVER: PRIVI_ALL,
        RESOURCE_PARTITION: PRIVI_ALL, RESOURCE_DB: PRIVI_ALL,
        RESOURCE_SPACE: PRIVI_ALL, RESOURCE_DOCUMENT: PRIVI_ALL,
        RESOURCE_INDEX: PRIVI_ALL, RESOURCE_ALIAS: PRIVI_ALL,
        RESOURCE_CONFIG: PRIVI_ALL, RESOURCE_USER: PRIVI_ALL,
        RESOURCE_ROLE: PRIVI_ALL,
    },
    "defaultSpaceAdmin": {
        RESOURCE_SPACE: PRIVI_ALL, RESOURCE_DOCUMENT: PRIVI_ALL,
        RESOURCE_INDEX: PRIVI_ALL, RESOURCE_ALIAS: PRIVI_READ,
    },
    "defaultDocumentAdmin": {
        RESOURCE_DOCUMENT: PRIVI_ALL, RESOURCE_INDEX: PRIVI_ALL,
    },
}


def parse_resources(endpoint: str, method: str) -> tuple[str, str]:
    """Map (endpoint, method) -> (resource, required privilege)
    (reference: entity/user.go:194 ParseResources). GET needs ReadOnly,
    everything else WriteOnly — except /document/{search,query} which are
    reads that ride POST."""
    privilege = PRIVI_READ if method == "GET" else PRIVI_WRITE
    e = endpoint
    if e.startswith("/clean_lock"):
        # rides GET but MUTATES state (clears expired space-mutation
        # locks) — classify as a cluster write so a blanket ReadOnly
        # grant cannot reach the ops escape hatch
        return RESOURCE_CLUSTER, PRIVI_WRITE
    if e.startswith("/cluster") or e == "/" or e.startswith("/members"):
        return RESOURCE_CLUSTER, privilege
    if (e.startswith("/servers") or e.startswith("/register")
            or e.startswith("/routers") or e.startswith("/schedule")):
        return RESOURCE_SERVER, privilege
    if e.startswith("/partitions"):
        return RESOURCE_PARTITION, privilege
    if e.startswith("/dbs"):
        return (RESOURCE_SPACE if "/spaces" in e else RESOURCE_DB), privilege
    if e.startswith("/backup"):
        return RESOURCE_SPACE, privilege
    if e.startswith("/document"):
        if "query" in e or "search" in e:
            return RESOURCE_DOCUMENT, PRIVI_READ
        return RESOURCE_DOCUMENT, PRIVI_WRITE
    if e.startswith("/index"):
        return RESOURCE_INDEX, privilege
    if e.startswith("/alias"):
        return RESOURCE_ALIAS, privilege
    if e.startswith("/config"):
        return RESOURCE_CONFIG, privilege
    if e.startswith("/users") or e.startswith("/user"):
        return RESOURCE_USER, privilege
    if e.startswith("/roles") or e.startswith("/role"):
        return RESOURCE_ROLE, privilege
    return RESOURCE_ALL, privilege


def has_permission(role_name: str, privileges: dict[str, str],
                   endpoint: str, method: str) -> None:
    """Raise 403 unless the role's grants cover the endpoint (reference:
    entity/user.go:300 HasPermissionForResources — root bypasses; a grant
    matches when equal to the need or WriteRead)."""
    if role_name == ROOT_NAME:
        return
    resource, needed = parse_resources(endpoint, method)
    grant = privileges.get(resource)
    if grant is None:
        grant = privileges.get(RESOURCE_ALL)
        if grant is None:
            raise RpcError(
                403, f"role {role_name!r} has no privilege on {resource}"
            )
        # user/role management is admin surface: a blanket ResourceAll
        # grant below WriteRead must not cover it, or a WriteOnly data
        # user could POST /users a root-role account and escalate
        # (reference: user management is ClusterAdmin/root-only)
        if resource in (RESOURCE_USER, RESOURCE_ROLE) and grant != PRIVI_ALL:
            raise RpcError(
                403,
                f"role {role_name!r} ResourceAll grant {grant} does not "
                f"extend to {resource} (admin surface)",
            )
        # cluster-topology mutations (recover/fail-server/member ops) are
        # likewise admin surface: a blanket WriteOnly data grant must not
        # let a data writer force replica re-placement or erase failure
        # records (reference: ops routes are ClusterAdmin-gated)
        if needed != PRIVI_READ and resource in (
            RESOURCE_SERVER, RESOURCE_CLUSTER, RESOURCE_PARTITION
        ) and grant != PRIVI_ALL:
            raise RpcError(
                403,
                f"role {role_name!r} ResourceAll grant {grant} does not "
                f"extend to {resource} mutations (admin surface)",
            )
    if grant == needed or grant == PRIVI_ALL:
        return
    raise RpcError(
        403,
        f"role {role_name!r} privilege {grant} on {resource} does not "
        f"cover {needed} for {method} {endpoint}",
    )


def hash_password(password: str, salt: str | None = None) -> str:
    salt = salt or secrets.token_hex(8)
    digest = hashlib.sha256((salt + password).encode()).hexdigest()
    return f"{salt}${digest}"


def verify_password(password: str, stored: str) -> bool:
    salt, _digest = stored.split("$", 1)
    return secrets.compare_digest(hash_password(password, salt), stored)


def parse_basic_auth(headers) -> tuple[str, str]:
    """Extract (user, password) from an Authorization: Basic header."""
    header = headers.get("Authorization", "")
    if not header.startswith("Basic "):
        raise RpcError(401, "missing Basic auth")
    try:
        raw = base64.b64decode(header[6:]).decode()
        user, _, password = raw.partition(":")
    except Exception as e:
        raise RpcError(401, "malformed Basic auth") from e
    return user, password


class AuthService:
    """Master-side user/role registry over the metastore."""

    def __init__(self, store, root_password: str = "secret",
                 bootstrap: bool = True):
        self.store = store
        self._root_password = root_password
        if bootstrap:
            self.ensure_bootstrap()

    def ensure_bootstrap(self) -> None:
        """Write root user + builtin roles if missing. In multi-master
        mode this runs on the metadata leader only (mutations replicate
        through the log; a follower couldn't propose them)."""
        if self.store.get(f"/user/{ROOT_NAME}") is None:
            self.store.put(f"/user/{ROOT_NAME}", {
                "name": ROOT_NAME,
                "password": hash_password(self._root_password),
                "role": "root",
            })
        for name, privileges in BUILTIN_ROLES.items():
            if self.store.get(f"/role/{name}") is None:
                self.store.put(f"/role/{name}",
                               {"name": name, "privileges": privileges})

    def create_user(self, name: str, password: str, role: str) -> dict:
        if self.store.get(f"/user/{name}") is not None:
            raise RpcError(409, f"user {name} exists")
        if self.store.get(f"/role/{role}") is None:
            raise RpcError(404, f"role {role} not found")
        user = {"name": name, "password": hash_password(password),
                "role": role}
        self.store.put(f"/user/{name}", user)
        return {"name": name, "role": role}

    def update_user(self, name: str, password: str | None = None,
                    role: str | None = None) -> dict:
        """Change a user's password and/or role (reference: updateUser).
        Root's role is fixed; its password may rotate."""
        u = self.store.get(f"/user/{name}")
        if u is None:
            raise RpcError(404, f"user {name} not found")
        if role is not None:
            if name == ROOT_NAME:
                raise RpcError(400, "cannot change root's role")
            if self.store.get(f"/role/{role}") is None:
                raise RpcError(404, f"role {role} not found")
            u["role"] = role
        if password is not None:
            u["password"] = hash_password(password)
        self.store.put(f"/user/{name}", u)
        return {"name": name, "role": u["role"]}

    def update_role(self, name: str, privileges: dict[str, str]) -> dict:
        """Replace a role's privilege map (reference:
        changeRolePrivilege). Built-in roles are immutable."""
        if name in BUILTIN_ROLES:
            raise RpcError(400, f"built-in role {name!r} is immutable")
        if self.store.get(f"/role/{name}") is None:
            raise RpcError(404, f"role {name} not found")
        role = {"name": name, "privileges": privileges}
        self.store.put(f"/role/{name}", role)
        return role

    def delete_user(self, name: str) -> None:
        if name == ROOT_NAME:
            raise RpcError(400, "cannot delete root")
        if not self.store.delete(f"/user/{name}"):
            raise RpcError(404, f"user {name} not found")

    def create_role(self, name: str, privileges: dict[str, str]) -> dict:
        if self.store.get(f"/role/{name}") is not None:
            raise RpcError(409, f"role {name} exists")
        role = {"name": name, "privileges": privileges}
        self.store.put(f"/role/{name}", role)
        return role

    def check(self, user: str, password: str) -> dict:
        """Validate credentials; returns the user's role record."""
        u = self.store.get(f"/user/{user}")
        if u is None or not verify_password(password, u["password"]):
            raise RpcError(401, "bad credentials")
        role = self.store.get(f"/role/{u['role']}") or {"privileges": {}}
        return {"name": user, "role": u["role"],
                "privileges": role["privileges"]}

    def authorize(self, record: dict, endpoint: str, method: str) -> None:
        """Per-request privilege check on a record returned by check()."""
        has_permission(record.get("role", ""),
                       record.get("privileges") or {}, endpoint, method)
