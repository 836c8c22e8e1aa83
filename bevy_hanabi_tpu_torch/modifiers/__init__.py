"""Composable effect modifiers (port of ``bevy_hanabi_tpu/modifiers``).

Only the ported modifiers are here, and only they register for serde: an
asset naming any other modifier fails ``from_json`` with the list of known
types.
"""

from .base import (  # noqa: F401
    MODIFIER_REGISTRY,
    Modifier,
    ModifierContext,
    ShapeDimension,
    modifier_from_json,
    register_modifier,
)
from .accel import AccelModifier, RadialAccelModifier, TangentAccelModifier  # noqa: F401
from .attr import InheritAttributeModifier, SetAttributeModifier  # noqa: F401
from .event import EmitSpawnEventModifier, EventEmitCondition  # noqa: F401
from .force import ConformToSphereModifier, LinearDragModifier  # noqa: F401
from .kill import KillAabbModifier, KillSphereModifier  # noqa: F401
from .output import (  # noqa: F401
    ColorBlendMask,
    ColorBlendMode,
    ColorOverLifetimeModifier,
    FlipbookModifier,
    ImageSampleMapping,
    OrientMode,
    OrientModifier,
    ParticleTextureModifier,
    RoundModifier,
    ScreenSpaceSizeModifier,
    SetColorModifier,
    SetSizeModifier,
    SizeOverLifetimeModifier,
)
from .position import (  # noqa: F401
    SetPositionCircleModifier,
    SetPositionCone3dModifier,
    SetPositionSphereModifier,
)
from .velocity import (  # noqa: F401
    SetVelocityCircleModifier,
    SetVelocitySphereModifier,
    SetVelocityTangentModifier,
)
