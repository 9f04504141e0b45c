"""Access control: users/groups as graph data, HMAC JWTs, enforcement.

Ports the reference's enterprise ACL semantics (edgraph/access_ee.go,
ee/acl/): principals live IN the graph under reserved `dgraph.*`
predicates —

    dgraph.xid        string @index(exact)   user/group id
    dgraph.password   password               user credential
    dgraph.user.group [uid]                  user -> group membership
    dgraph.group.acl  string                 JSON [{predicate, perm}] per group

Login verifies the password (scrypt; ref bcrypt in types/password.go),
then issues an access JWT + refresh JWT signed HS256 with the cluster's
hmac secret (ref access_ee.go:229 getAccessJwt). Authorization loads a
group->predicate->perm cache refreshed on a TTL (ref acl_cache.go,
RefreshAcls) and checks Read(4)/Write(2)/Modify(1) bits per predicate
(ref ee/acl/acl.go ops). Members of `guardians` bypass all checks; the
bootstrap superuser is `groot` (ref ResetAcl access_ee.go:356).

JWTs are compact JOSE HS256 built on stdlib hmac — no external jwt
dependency.

Port of `dgraph_tpu/server/acl.py`: a copy, its imports pointed at this
package. `block_predicates` and
`query_predicates` are the ones in `engine/result_cache` (one
definition, re-exported here).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Optional

from dgraph_tpu_torch.engine.db import GraphDB
# one definition of the footprint walks, shared with the result cache
from dgraph_tpu_torch.engine.result_cache import (  # noqa: F401
    block_predicates, query_predicates,
)

GROOT = "groot"
GUARDIANS = "guardians"

READ, WRITE, MODIFY = 4, 2, 1

ACL_SCHEMA = """
dgraph.xid: string @index(exact) @upsert .
dgraph.password: password .
dgraph.user.group: [uid] @reverse .
dgraph.group.acl: string .
"""


class AclError(Exception):
    pass


import re as _re

_XID_RE = _re.compile(r"^[A-Za-z0-9_.-]{1,100}$")


def _check_xid(xid: str) -> str:
    """Principal ids are interpolated into queries/N-Quads: restrict the
    alphabet so injection is structurally impossible (the reference
    enforces simple ids too, ee/acl/utils.go)."""
    if not _XID_RE.match(xid):
        raise AclError(
            f"invalid user/group id {xid!r}: only [A-Za-z0-9_.-] allowed")
    return xid


# ---------------------------------------------------------------- JWT


def _b64(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def jwt_encode(claims: dict, secret: bytes) -> str:
    header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    body = _b64(json.dumps(claims, separators=(",", ":")).encode())
    signing = f"{header}.{body}".encode()
    sig = _b64(hmac.new(secret, signing, hashlib.sha256).digest())
    return f"{header}.{body}.{sig}"


def jwt_decode(token: str, secret: bytes) -> dict:
    try:
        header, body, sig = token.split(".")
    except ValueError:
        raise AclError("malformed jwt")
    signing = f"{header}.{body}".encode()
    want = _b64(hmac.new(secret, signing, hashlib.sha256).digest())
    if not hmac.compare_digest(want, sig):
        raise AclError("jwt signature mismatch")
    claims = json.loads(_unb64(body))
    # JWT `exp` is wall-clock by spec (RFC 7519 NumericDate)
    if claims.get("exp", 0) < time.time():  # dglint: disable=DG06
        raise AclError("jwt expired")
    return claims


# ------------------------------------------------------- predicate walks


def nquad_predicates(set_nq: str = "", del_nq: str = "",
                     set_json=None, delete_json=None) -> list[str]:
    """Predicates a mutation touches (ref parsePredsFromMutation)."""
    from dgraph_tpu_torch.gql.nquad import parse_json_mutation, parse_rdf
    preds: set[str] = set()
    for txt in (set_nq, del_nq):
        if txt:
            for nq in parse_rdf(txt):
                preds.add(nq.predicate)
    for j, deletion in ((set_json, False), (delete_json, True)):
        if j is not None:
            for nq in parse_json_mutation(j, delete=deletion):
                preds.add(nq.predicate)
    preds.discard("*")
    return sorted(preds)


def schema_predicates(schema_text: str) -> list[str]:
    """Predicates an alter defines (throwaway parse)."""
    from dgraph_tpu_torch.models.schema import SchemaState
    st = SchemaState()
    preds, _types = st.apply_text(schema_text)
    return sorted(p.predicate for p in preds)


# ---------------------------------------------------------------- manager


class AclManager:
    def __init__(self, db: GraphDB, secret: bytes,
                 access_ttl: float = 6 * 3600,
                 refresh_ttl: float = 30 * 24 * 3600,
                 cache_ttl: float = 5.0):
        self.db = db
        self.secret = secret
        self.access_ttl = access_ttl
        self.refresh_ttl = refresh_ttl
        self.cache_ttl = cache_ttl
        self._cache: dict[str, dict[str, int]] = {}
        # -inf forces the first refresh under ANY clock origin (the
        # TTL clock is time.monotonic(), whose epoch is arbitrary —
        # 0.0 would skip the refresh on a freshly booted host)
        self._cache_at = float("-inf")
        self._ensure_bootstrap()

    # ----------------------------------------------------------- bootstrap

    def _ensure_bootstrap(self):
        """Create groot + guardians on first boot (ref ResetAcl,
        access_ee.go:356; upsert keeps it idempotent)."""
        self.db.alter(ACL_SCHEMA)
        res = self.db.query(
            '{ q(func: eq(dgraph.xid, "%s")) { uid } }' % GROOT)
        if res["data"]["q"]:
            return
        self.db.mutate(set_nquads=f'''
_:g <dgraph.xid> "{GUARDIANS}" .
_:u <dgraph.xid> "{GROOT}" .
_:u <dgraph.password> "password" .
_:u <dgraph.user.group> _:g .
''')

    # ------------------------------------------------------------- login

    def login(self, userid: str = "", password: str = "",
              refresh_token: str = "") -> dict:
        """Password or refresh-token login -> new access+refresh JWTs
        (ref access_ee.go:42 Login / :110 authenticate)."""
        if refresh_token:
            claims = jwt_decode(refresh_token, self.secret)
            if claims.get("typ") != "refresh":
                raise AclError("not a refresh jwt")
            userid = _check_xid(claims["userid"])
        else:
            _check_xid(userid)
            q = ('{ q(func: eq(dgraph.xid, "%s")) '
                 '@filter(checkpwd(dgraph.password, %s)) { uid } }'
                 % (userid, json.dumps(password)))
            res = self.db.query(q)
            if not res["data"]["q"]:
                raise AclError("invalid login credentials")
        groups = self._groups_of(userid)
        # wall clock: `exp` claims are absolute wall-clock instants
        now = time.time()  # dglint: disable=DG06
        access = jwt_encode({"userid": userid, "groups": groups,
                             "typ": "access",
                             "exp": now + self.access_ttl}, self.secret)
        refresh = jwt_encode({"userid": userid, "typ": "refresh",
                              "exp": now + self.refresh_ttl}, self.secret)
        return {"accessJwt": access, "refreshJwt": refresh}

    def _groups_of(self, userid: str) -> list[str]:
        _check_xid(userid)
        res = self.db.query(
            '{ q(func: eq(dgraph.xid, "%s")) '
            '{ dgraph.user.group { dgraph.xid } } }' % userid)
        out = []
        for u in res["data"]["q"]:
            for g in u.get("dgraph.user.group", []):
                if "dgraph.xid" in g:
                    out.append(g["dgraph.xid"])
        return out

    # ----------------------------------------------------------- acl cache

    def _perms(self) -> dict[str, dict[str, int]]:
        """group -> predicate -> perm bits, cached with TTL
        (ref acl_cache.go:113 update / RefreshAcls)."""
        now = time.monotonic()
        if now - self._cache_at > self.cache_ttl:
            table: dict[str, dict[str, int]] = {}
            res = self.db.query(
                '{ q(func: has(dgraph.group.acl)) '
                '{ dgraph.xid dgraph.group.acl } }')
            for g in res["data"]["q"]:
                try:
                    acl = json.loads(g.get("dgraph.group.acl", "[]"))
                except ValueError:
                    continue
                table[g.get("dgraph.xid", "")] = {
                    e["predicate"]: int(e["perm"]) for e in acl
                    if "predicate" in e}
            self._cache = table
            self._cache_at = now
        return self._cache

    def _allowed(self, claims: dict, pred: str, bit: int) -> bool:
        if GUARDIANS in claims.get("groups", []):
            return True
        if pred.startswith("dgraph."):
            return False  # reserved predicates are guardian-only
        perms = self._perms()
        for g in claims.get("groups", []):
            if perms.get(g, {}).get(pred, 0) & bit:
                return True
        return False

    # -------------------------------------------------------- enforcement

    def authorize(self, token: str) -> dict:
        claims = jwt_decode(token, self.secret)
        if claims.get("typ") != "access":
            raise AclError("not an access jwt")
        return claims

    def authorize_query(self, token: str, predicates: list[str],
                        claims: dict | None = None):
        """Every queried predicate needs Read (ref access_ee.go
        authorizeQuery). Pass pre-decoded `claims` to skip a redundant
        JWT verification."""
        if claims is None:
            claims = self.authorize(token)
        for p in predicates:
            base = p[1:] if p.startswith("~") else p
            if not self._allowed(claims, base, READ):
                raise AclError(
                    f"unauthorized to query predicate {base!r}")

    def authorize_mutation(self, token: str, predicates: list[str],
                           claims: dict | None = None):
        if claims is None:
            claims = self.authorize(token)
        for p in predicates:
            if not self._allowed(claims, p, WRITE):
                raise AclError(
                    f"unauthorized to mutate predicate {p!r}")

    def authorize_alter(self, token: str, predicates: list[str],
                        drop: bool = False):
        claims = self.authorize(token)
        if drop and GUARDIANS not in claims.get("groups", []):
            raise AclError("drop operations need guardian membership")
        for p in predicates:
            if not self._allowed(claims, p, MODIFY):
                raise AclError(
                    f"unauthorized to alter predicate {p!r}")

    # ------------------------------------------------------------ admin
    # (the `dgraph acl` CLI surface, ee/acl/acl.go)

    def add_user(self, userid: str, password: str):
        _check_xid(userid)
        if self._uid_of(userid):
            raise AclError(f"user {userid!r} already exists")
        self.db.mutate(set_nquads=f'_:u <dgraph.xid> "{userid}" .\n'
                                  f'_:u <dgraph.password> {json.dumps(password)} .')

    def add_group(self, groupid: str):
        _check_xid(groupid)
        if self._uid_of(groupid):
            raise AclError(f"group {groupid!r} already exists")
        self.db.mutate(set_nquads=f'_:g <dgraph.xid> "{groupid}" .\n'
                                  f'_:g <dgraph.group.acl> "[]" .')

    def delete_principal(self, xid: str):
        uid = self._uid_of(xid)
        if not uid:
            raise AclError(f"{xid!r} not found")
        self.db.mutate(del_nquads=f"<{uid}> * * .")

    def set_groups(self, userid: str, groupids: list[str]):
        uid = self._uid_of(userid)
        if not uid:
            raise AclError(f"user {userid!r} not found")
        self.db.mutate(del_nquads=f"<{uid}> <dgraph.user.group> * .")
        lines = []
        for g in groupids:
            gid = self._uid_of(g)
            if not gid:
                raise AclError(f"group {g!r} not found")
            lines.append(f"<{uid}> <dgraph.user.group> <{gid}> .")
        if lines:
            self.db.mutate(set_nquads="\n".join(lines))

    def chmod(self, groupid: str, predicate: str, perm: int):
        """Set a group's perm bits on a predicate (ref acl.go chMod)."""
        gid = self._uid_of(groupid)
        if not gid:
            raise AclError(f"group {groupid!r} not found")
        res = self.db.query(
            '{ q(func: eq(dgraph.xid, "%s")) { dgraph.group.acl } }'
            % groupid)
        acl = []
        rows = res["data"]["q"]
        if rows and "dgraph.group.acl" in rows[0]:
            acl = json.loads(rows[0]["dgraph.group.acl"])
        acl = [e for e in acl if e.get("predicate") != predicate]
        if perm:
            acl.append({"predicate": predicate, "perm": perm})
        self.db.mutate(set_nquads=(
            f"<{gid}> <dgraph.group.acl> {json.dumps(json.dumps(acl))} ."))
        self._cache_at = float("-inf")  # force refresh

    def info(self) -> dict:
        res = self.db.query(
            '{ users(func: has(dgraph.password)) { dgraph.xid '
            '  dgraph.user.group { dgraph.xid } } '
            '  groups(func: has(dgraph.group.acl)) { dgraph.xid '
            '  dgraph.group.acl } }')
        return res["data"]

    def _uid_of(self, xid: str) -> Optional[str]:
        _check_xid(xid)
        res = self.db.query(
            '{ q(func: eq(dgraph.xid, "%s")) { uid } }' % xid)
        rows = res["data"]["q"]
        return rows[0]["uid"] if rows else None
