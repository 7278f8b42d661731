"""Mythril-level plugin discovery and loading (``mythril_tpu_torch/plugin/``)
against the JAX package's, on the CPU.

A fake distribution on ``sys.path`` (a ``.dist-info`` whose
``entry_points.txt`` fills the ``mythril.plugins`` group) offers a
detection-module plugin written against each package's interface.  Both
packages read the same group.  Each loader loads the plugin of its own
package into its detection-module registry; the port skips the JAX
package's with one log line naming it, and never half-loads it.  The
JAX loader is given a distribution of its own plugin alone: its
discovery raises on a plugin of another interface (it does not skip),
which is the JAX package's behaviour and not changed here.
"""

import importlib
import logging
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": "mythril_tpu", "port": "mythril_tpu_torch"}

PLUGIN_MODULE = '''
from {package}.analysis.module.base import DetectionModule, EntryPoint
from {package}.plugin.interface import MythrilPlugin


class {cls}(DetectionModule, MythrilPlugin):
    """A detection module installed as a Mythril plugin."""

    name = "{cls} detector"
    swc_id = "000"
    description = "fake plugin of the {package} interface"
    entry_point = EntryPoint.CALLBACK
    pre_hooks = ["STOP"]
    plugin_default_enabled = True

    def _execute(self, state):
        return []
'''

#: entry point name -> (module, class, package)
PLUGINS = {
    "port_fake": ("fake_port_plugin", "PortFakePlugin", "mythril_tpu_torch"),
    "jax_fake": ("fake_jax_plugin", "JaxFakePlugin", "mythril_tpu"),
}


def write_distribution(root, names):
    """A distribution in ``root`` offering the plugins ``names``."""
    os.makedirs(root, exist_ok=True)
    info = os.path.join(root, "fake_mythril_plugins-0.1.dist-info")
    os.makedirs(info, exist_ok=True)
    with open(os.path.join(info, "METADATA"), "w") as fh:
        fh.write("Metadata-Version: 2.1\nName: fake-mythril-plugins\n"
                 "Version: 0.1\n")
    lines = ["[mythril.plugins]"]
    for name in names:
        module, cls, package = PLUGINS[name]
        lines.append(f"{name} = {module}:{cls}")
        with open(os.path.join(root, f"{module}.py"), "w") as fh:
            fh.write(PLUGIN_MODULE.format(package=package, cls=cls))
    with open(os.path.join(info, "entry_points.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return root


def mod(side, path):
    return importlib.import_module(f"{SIDES[side]}.{path}")


@pytest.fixture
def fresh_loaders(monkeypatch):
    """Both packages' plugin singletons made afresh, the fake modules
    forgotten, and the detection-module registries put back after."""
    registries = {}
    for side in SIDES:
        singleton = mod(side, "support.support_utils").Singleton
        for cls in (mod(side, "plugin.discovery").PluginDiscovery,
                    mod(side, "plugin.loader").MythrilPluginLoader):
            monkeypatch.delitem(singleton._instances, cls, raising=False)
        monkeypatch.setattr(mod(side, "plugin.discovery").PluginDiscovery,
                            "_plugins", {})
        loader = mod(side, "analysis.module.loader").ModuleLoader()
        registries[side] = (loader, list(loader._modules))
    for module, _cls, _package in PLUGINS.values():
        monkeypatch.delitem(sys.modules, module, raising=False)
    yield
    for side, (loader, modules) in registries.items():
        loader._modules[:] = modules
        singleton = mod(side, "support.support_utils").Singleton
        for cls in (mod(side, "plugin.discovery").PluginDiscovery,
                    mod(side, "plugin.loader").MythrilPluginLoader):
            singleton._instances.pop(cls, None)
    for module, _cls, _package in PLUGINS.values():
        sys.modules.pop(module, None)


def _loaded_names(side):
    loader = mod(side, "analysis.module.loader").ModuleLoader()
    return [type(m).__name__ for m in loader.get_detection_modules()]


def test_port_loads_its_plugin_and_skips_the_jax_one(
        tmp_path, monkeypatch, caplog, fresh_loaders):
    root = write_distribution(str(tmp_path / "both"), sorted(PLUGINS))
    monkeypatch.syspath_prepend(root)
    caplog.set_level(logging.INFO, logger="mythril_tpu_torch.plugin")
    discovery = mod("port", "plugin.discovery").PluginDiscovery()
    assert sorted(discovery.get_plugins()) == ["port_fake"]
    loader = mod("port", "plugin.loader").MythrilPluginLoader()
    assert [type(p).__name__ for p in loader.loaded_plugins] == [
        "PortFakePlugin"]
    assert "PortFakePlugin" in _loaded_names("port")
    assert "JaxFakePlugin" not in _loaded_names("port")
    assert "PortFakePlugin" not in _loaded_names("jax")
    skipped = [r.getMessage() for r in caplog.records
               if "skipping plugin" in r.getMessage()]
    assert len(skipped) == 1 and "jax_fake" in skipped[0]


def test_jax_loads_its_plugin_from_the_same_group(tmp_path, monkeypatch,
                                                  fresh_loaders):
    root = write_distribution(str(tmp_path / "jax"), ["jax_fake"])
    monkeypatch.syspath_prepend(root)
    loader = mod("jax", "plugin.loader").MythrilPluginLoader()
    assert [type(p).__name__ for p in loader.loaded_plugins] == [
        "JaxFakePlugin"]
    assert "JaxFakePlugin" in _loaded_names("jax")
    # the port sees the same entry point and skips it
    discovery = mod("port", "plugin.discovery").PluginDiscovery()
    assert discovery.get_plugins() == []


def test_port_discovery_builds_only_its_own_plugins(tmp_path, monkeypatch,
                                                     fresh_loaders):
    root = write_distribution(str(tmp_path / "both"), sorted(PLUGINS))
    monkeypatch.syspath_prepend(root)
    discovery = mod("port", "plugin.discovery").PluginDiscovery()
    assert discovery.is_installed("port_fake")
    assert not discovery.is_installed("jax_fake")
    assert discovery.get_plugins(default_enabled=True) == ["port_fake"]
    assert discovery.get_plugins(default_enabled=False) == []
    plugin = discovery.build_plugin("port_fake", {})
    interface = mod("port", "plugin.interface")
    assert isinstance(plugin, interface.MythrilPlugin)
    with pytest.raises(ValueError):
        discovery.build_plugin("jax_fake", {})


def test_a_plugin_that_fails_to_import_is_skipped(tmp_path, monkeypatch,
                                                  caplog, fresh_loaders):
    root = write_distribution(str(tmp_path / "broken"), ["port_fake"])
    info = os.path.join(root, "fake_mythril_plugins-0.1.dist-info")
    with open(os.path.join(info, "entry_points.txt"), "a") as fh:
        fh.write("broken = no_such_module_anywhere:Plugin\n")
    monkeypatch.syspath_prepend(root)
    caplog.set_level(logging.WARNING, logger="mythril_tpu_torch.plugin")
    discovery = mod("port", "plugin.discovery").PluginDiscovery()
    assert discovery.get_plugins() == ["port_fake"]
    assert any("broken" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_loader_refuses_what_is_not_a_plugin(side, fresh_loaders):
    loader = mod(side, "plugin.loader")
    instance = loader.MythrilPluginLoader()
    with pytest.raises(ValueError):
        instance.load(object())
    with pytest.raises(loader.UnsupportedPluginType):
        instance.load(mod(side, "plugin.interface").MythrilCLIPlugin())


@pytest.mark.parametrize("side", sorted(SIDES))
def test_plugin_interface_matches_jax(side):
    interface = mod(side, "plugin.interface")
    plugin = interface.MythrilPlugin()
    assert repr(plugin) == "Plugin Name - 0.0.1  - Default Author"
    assert issubclass(interface.MythrilLaserPlugin, interface.MythrilPlugin)
    assert issubclass(
        interface.MythrilLaserPlugin,
        mod(side, "laser.plugin.builder").PluginBuilder)


def test_cli_loads_plugins_before_an_analysis(tmp_path):
    """The port's CLI builds the loader before ``disassemble`` and
    ``analyze``, as the JAX CLI does: the plugin is loaded, the JAX one
    skipped, and the command runs."""
    root = write_distribution(str(tmp_path / "both"), sorted(PLUGINS))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [root, ROOT, os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run(
        [sys.executable, "-m", "mythril_tpu_torch", "disassemble", "-c",
         "0x6000", "-v", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "PUSH1 0x00" in run.stdout
    assert "Loading plugin: PortFakePlugin detector" in run.stderr
    assert "skipping plugin jax_fake" in run.stderr
    assert "Traceback" not in run.stderr
