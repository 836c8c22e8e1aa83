"""Composable effect modifiers (port of ``bevy_hanabi_tpu/modifiers``).

Only the modifiers the ported slice runs are here, and only they register
for serde: an asset naming any other modifier fails ``from_json`` with the
list of known types.
"""

from .base import (  # noqa: F401
    MODIFIER_REGISTRY,
    Modifier,
    ModifierContext,
    ShapeDimension,
    modifier_from_json,
    register_modifier,
)
from .attr import InheritAttributeModifier, SetAttributeModifier  # noqa: F401
from .event import EmitSpawnEventModifier, EventEmitCondition  # noqa: F401
from .output import (  # noqa: F401
    ColorBlendMask,
    ColorBlendMode,
    ColorOverLifetimeModifier,
    OrientMode,
    OrientModifier,
    SizeOverLifetimeModifier,
)
from .position import SetPositionSphereModifier  # noqa: F401
from .velocity import SetVelocitySphereModifier  # noqa: F401
