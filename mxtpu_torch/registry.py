"""Generic class-factory registry (counterpart of mxtpu/registry.py;
parity: python/mxnet/registry.py).

This is the PUBLIC ``mx.registry`` facade for user-defined class
families (register/alias/create factories keyed by base class). The
built-in optimizer/initializer/metric registries live in their own
modules (``optimizer``, ``initializer``, ``metric``) — look there, not
here, for where those are actually registered."""
from __future__ import annotations

import json
import warnings

from .base import MXNetError

_REGISTRY = {}


def _table(base_class):
    return _REGISTRY.setdefault(base_class, {})


def get_register_func(base_class, nickname):
    """Return a registrator for subclasses of ``base_class``."""
    registry = _table(base_class)

    def register(klass, name=None):
        if not (isinstance(klass, type) and issubclass(klass, base_class)):
            raise MXNetError("can only register subclasses of %s"
                             % base_class.__name__)
        key = (name or klass.__name__).lower()
        if key in registry and registry[key] is not klass:
            warnings.warn("new %s %r overrides existing %s %s"
                          % (nickname, key, nickname,
                             registry[key].__name__), UserWarning,
                          stacklevel=2)
        registry[key] = klass
        return klass

    return register


def get_alias_func(base_class, nickname):
    """Return a decorator factory registering a class under many names."""
    register = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            for name in aliases:
                register(klass, name)
            return klass
        return reg

    return alias


def get_create_func(base_class, nickname):
    """Return a creator: create(name_or_instance_or_json, *args, **kwargs).

    Accepts an instance (returned as-is), a registered name, a dict of
    constructor kwargs, or the reference's JSON spellings
    ``'["name", {kwargs}]'`` / ``'{"nickname": ..., kwargs}'``."""
    registry = _table(base_class)

    def create(*args, **kwargs):
        if args:
            name, args = args[0], args[1:]
        else:
            name = kwargs.pop(nickname)
        if isinstance(name, base_class):
            if args or kwargs:
                raise MXNetError(
                    "%s is already an instance; extra arguments are "
                    "invalid" % nickname)
            return name
        if isinstance(name, dict):
            return create(**name)
        if not isinstance(name, str):
            raise MXNetError("%s must be a string or %s instance"
                             % (nickname, base_class.__name__))
        if name.startswith("[") or name.startswith("{"):
            if args or kwargs:
                raise MXNetError("JSON %s spec does not combine with "
                                 "extra arguments" % nickname)
            if name.startswith("["):
                name, kw = json.loads(name)
                return create(name, **kw)
            return create(**json.loads(name))
        key = name.lower()
        if key not in registry:
            raise MXNetError("%s %r is not registered (known: %s)"
                             % (nickname, name, sorted(registry)))
        return registry[key](*args, **kwargs)

    return create
